"""Plain fp32 reference of DeepSeek-V2's first layer: multi-head latent
attention (MLA) with YaRN rope, then a dense SwiGLU MLP, each pre-normed
and added to the residual.  The attention pieces are shared with the MoE
layers (``mla_moe.py``).

With x the residual, N the norm x / rms(x) * (1 + s) and h = N(x):

    q = h W_q [H, dn + dr], split into q_n [dn] and q_r [dr];
    [c, k_r] = h W_kva, c [dc], k_r [dr];
    [k_n, v] = N_kv(c) W_kvb [H, dn + dv];
    q_r, k_r rotated by YaRN rope (:func:`inv_freq`), k_r shared by the
    heads;
    o = softmax(m^2 [q_n, q_r] [k_n, k_r]^T / sqrt(dn + dr), causal) v,
    m = 0.1 mscale_all_dim ln(factor) + 1;
    x += o W_o.

Attention is ``common.CausalAttention`` with v padded with zeros to the
query/key width and its output sliced back to dv.

Departures from the published DeepSeek-V2-Lite, as the port defines its
model: rope turns the two halves of the rope part together (DeepSeek's
code turns adjacent pairs, the same map after a permutation of the rope
columns of W_q and W_kva); the norms' scale starts at 0 and multiplies as
1 + s.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from perfbench.reference.common import CausalAttention, rmsnorm, silu
from perfbench.weights import Leaf


def _widths(cfg: dict) -> tuple:
    return (cfg["d_model"], cfg["n_heads"], cfg["kv_lora_rank"],
            cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
            cfg["v_head_dim"])


def _normal(fan_in: int) -> tuple:
    return ("normal", 1.0 / math.sqrt(fan_in))


ZERO = ("const", 0.0)


def attention_leaves(cfg: dict) -> list:
    """The pre-norm and MLA's leaves (the port's names and order)."""
    d, h, dc, dn, dr, dv = _widths(cfg)
    return [Leaf("ln_attn.scale", (d,), ZERO, False),
            Leaf("attn.wq", (d, h, dn + dr), _normal(d), True),
            Leaf("attn.wkv_a", (d, dc + dr), _normal(d), True),
            Leaf("attn.kv_norm", (dc,), ZERO, False),
            Leaf("attn.wkv_b", (dc, h, dn + dv), _normal(dc), True),
            Leaf("attn.wo", (h, dv, d), _normal(h * dv), True)]


def leaves(cfg: dict) -> list:
    d, f = cfg["d_model"], cfg["dense_d_ff"]
    return attention_leaves(cfg) + [
        Leaf("ln_mlp.scale", (d,), ZERO, False),
        Leaf("mlp.w_up", (d, f), _normal(d), True),
        Leaf("mlp.w_down", (f, d), _normal(f), True),
        Leaf("mlp.w_gate", (d, f), _normal(d), True)]


def attention_flops(cfg: dict, seq_len: int) -> float:
    """Causal MLA's model FLOPs a token beyond its weights' (forward and
    backward): scores at the query/key width, context at the value width,
    6 T H (dqk + dv) / 2."""
    dqk = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
    return 3.0 * seq_len * cfg["n_heads"] * (dqk + cfg["v_head_dim"])


def flops_per_token(cfg: dict, seq_len: int) -> float:
    return attention_flops(cfg, seq_len)


def inv_freq(cfg: dict, device=None) -> torch.Tensor:
    """YaRN's inverse frequencies over the dr / 2 pairs i: f_i =
    theta^(-2i/dr); low = floor(dr ln(L / (beta_fast 2 pi)) / (2 ln
    theta)), high = ceil(the same at beta_slow), clamped to [0, dr - 1];
    r_i = clamp((i - low) / (high - low), 0, 1); f_i / s r_i + f_i (1 -
    r_i).  Worked out in fp64, given in fp32."""
    dr, theta = cfg["qk_rope_head_dim"], float(cfg["rope_theta"])
    s, length = cfg["yarn_factor"], cfg["yarn_original_len"]
    i = torch.arange(dr // 2, dtype=torch.float64, device=device)
    f = theta ** (-2.0 * i / dr)
    corr = lambda beta: dr * math.log(length / (beta * 2 * math.pi)) \
        / (2 * math.log(theta))
    low = max(math.floor(corr(cfg["yarn_beta_fast"])), 0)
    high = min(math.ceil(corr(cfg["yarn_beta_slow"])), dr - 1)
    r = torch.clamp((i - low) / (high - low), 0.0, 1.0)
    return (f / s * r + f * (1 - r)).float()


def softmax_scale2(cfg: dict) -> float:
    """m^2: YaRN's attention scale, squared, from the configuration's
    mscale (``rope_scaling.mscale_all_dim``).  The rope's cos and sin carry
    mscale / mscale_all_dim, which the source makes 1."""
    rs = cfg["rope_scaling"]
    if rs["mscale"] != rs["mscale_all_dim"]:
        raise ValueError("the reference takes equal mscale and "
                         "mscale_all_dim only")
    m = 0.1 * cfg["yarn_mscale"] * math.log(cfg["yarn_factor"]) + 1
    return m * m


def rope(x: torch.Tensor, freq: torch.Tensor) -> torch.Tensor:
    """x [B, T, H, dr] rotated at positions 0..T-1, the two halves
    together."""
    t, half = x.shape[1], x.shape[-1] // 2
    ang = torch.arange(t, dtype=torch.float32, device=x.device)[:, None] \
        * freq
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attend(p: dict, x: torch.Tensor, cfg: dict, prec) -> torch.Tensor:
    """x plus MLA of N(x)."""
    d, heads, dc, dn, dr, dv = _widths(cfg)
    eps = cfg["norm_eps"]
    b, t, _ = x.shape
    h = prec(rmsnorm(x, p["ln_attn.scale"], eps))
    q = torch.einsum("btd,dhk->bthk", h, prec(p["attn.wq"]))
    kva = torch.matmul(h, prec(p["attn.wkv_a"]))
    c = prec(rmsnorm(kva[..., :dc], p["attn.kv_norm"], eps))
    kv = torch.einsum("btc,chk->bthk", c, prec(p["attn.wkv_b"]))
    freq = inv_freq(cfg, x.device)
    q = torch.cat([q[..., :dn], rope(q[..., dn:], freq)], dim=-1) \
        * softmax_scale2(cfg)
    k_r = rope(kva[..., None, dc:], freq).expand(b, t, heads, dr)
    k = torch.cat([kv[..., :dn], k_r], dim=-1)
    v = F.pad(kv[..., dn:], (0, dn + dr - dv))
    o = CausalAttention.apply(q, k, v, prec)[..., :dv]
    return x + torch.einsum("bthk,hkd->btd", prec(o), prec(p["attn.wo"]))


def swiglu(h: torch.Tensor, up, down, gate, prec) -> torch.Tensor:
    """silu(h W_gate) * (h W_up), then W_down; h already rounded."""
    act = silu(torch.matmul(h, prec(gate))) * torch.matmul(h, prec(up))
    return torch.matmul(prec(act), prec(down))


def apply(p: dict, x: torch.Tensor, cfg: dict, prec) -> torch.Tensor:
    x = attend(p, x, cfg, prec)
    h = prec(rmsnorm(x, p["ln_mlp.scale"], cfg["norm_eps"]))
    return x + swiglu(h, p["mlp.w_up"], p["mlp.w_down"], p["mlp.w_gate"],
                      prec)
