"""Plain fp32 reference of a dense decoder layer (Llama-style, as Yi-6B):
pre-norm grouped-query attention with rotary embedding and causal
masking, then a pre-norm SwiGLU MLP, each added to the residual.

Departures from the published Yi-6B, all as the port defines its model:
the norms compute x / rms(x) * (1 + scale) with the scale starting at 0
and eps from the configuration (the port's 1e-6; Yi states 1e-5); the
weights are laid out head-major ([D, H, dh], [H, dh, D]).
"""
from __future__ import annotations

import math

import torch

from perfbench.reference.common import (CausalAttention, rmsnorm, rope,
                                        silu)
from perfbench.weights import Leaf


def leaves(cfg: dict) -> list:
    """The layer's leaves (the port's names), with their initial
    distributions."""
    d, h, kh, dh, f = (cfg[k] for k in ("d_model", "n_heads", "n_kv_heads",
                                        "head_dim", "d_ff"))
    n = lambda fan_in: ("normal", 1.0 / math.sqrt(fan_in))
    zero = ("const", 0.0)
    return [Leaf("ln_attn.scale", (d,), zero, False),
            Leaf("attn.wq", (d, h, dh), n(d), True),
            Leaf("attn.wk", (d, kh, dh), n(d), True),
            Leaf("attn.wv", (d, kh, dh), n(d), True),
            Leaf("attn.wo", (h, dh, d), n(h * dh), True),
            Leaf("ln_mlp.scale", (d,), zero, False),
            Leaf("mlp.w_up", (d, f), n(d), True),
            Leaf("mlp.w_down", (f, d), n(f), True),
            Leaf("mlp.w_gate", (d, f), n(d), True)]


def flops_per_token(cfg: dict, seq_len: int) -> float:
    """Causal attention's model FLOPs a token beyond its weights' (forward
    and backward: 6 T H dh)."""
    return 6.0 * seq_len * cfg["n_heads"] * cfg["head_dim"]


def apply(p: dict, x: torch.Tensor, cfg: dict, prec) -> torch.Tensor:
    eps = cfg["norm_eps"]
    h = prec(rmsnorm(x, p["ln_attn.scale"], eps))
    q, k, v = (torch.einsum("btd,dhk->bthk", h, prec(p[f"attn.{w}"]))
               for w in ("wq", "wk", "wv"))
    q, k = rope(q, cfg["rope_theta"]), rope(k, cfg["rope_theta"])
    o = CausalAttention.apply(q, k, v, prec)
    x = x + torch.einsum("bthk,hkd->btd", prec(o), prec(p["attn.wo"]))
    h = prec(rmsnorm(x, p["ln_mlp.scale"], eps))
    gate = silu(torch.matmul(h, prec(p["mlp.w_gate"])))
    up = torch.matmul(h, prec(p["mlp.w_up"]))
    return x + torch.matmul(prec(gate * up), prec(p["mlp.w_down"]))
