"""Plain fp32 reference of one chip's share of a DeepSeek-V2 MoE layer:
MLA as ``mla_dense.py``, then, with h = N(x),

    p = softmax(h W_r) over all the layer's ``router_experts`` experts;
    the top ``moe_top_k`` by value (ties to the lower index), not
    renormalised;
    y = S(h) + sum over the chosen experts e held here of p_e E_e(h),

S the shared experts (one SwiGLU of ``shared_d_ff``) and E_e a SwiGLU of
``d_ff``; x += y.  The chip holds ``n_experts`` experts from
``expert_offset`` on; what the others would add is left out, as in the
program.  Each held expert is computed on the tokens that chose it.
"""
from __future__ import annotations

import torch

from perfbench.reference.blocks.mla_dense import (ZERO, _normal, attend,
                                                  attention_flops,
                                                  attention_leaves, swiglu)
from perfbench.reference.common import rmsnorm
from perfbench.weights import Leaf


def leaves(cfg: dict) -> list:
    """The held experts are not counted as products: a token reaches
    only the chosen ones (:func:`flops_per_token` counts their share)."""
    d, f, fs = cfg["d_model"], cfg["d_ff"], cfg["shared_d_ff"]
    n, e = cfg["n_experts"], cfg["router_experts"]
    return attention_leaves(cfg) + [
        Leaf("ln_moe.scale", (d,), ZERO, False),
        Leaf("moe.router", (d, e), _normal(d), True),
        Leaf("moe.w_up", (n, d, f), _normal(d), False),
        Leaf("moe.w_down", (n, f, d), _normal(f), False),
        Leaf("moe.w_gate", (n, d, f), _normal(d), False),
        Leaf("moe.shared.w_up", (d, fs), _normal(d), True),
        Leaf("moe.shared.w_down", (fs, d), _normal(fs), True),
        Leaf("moe.shared.w_gate", (d, fs), _normal(d), True)]


def flops_per_token(cfg: dict, seq_len: int) -> float:
    """MLA's, plus the held experts at their expected share of a token:
    top-k x held / routed experts (6 x 8 / 64 = 0.75), 6 x 3 D F each."""
    share = cfg["moe_top_k"] * cfg["n_experts"] / cfg["router_experts"]
    return attention_flops(cfg, seq_len) + \
        6.0 * share * 3 * cfg["d_model"] * cfg["d_ff"]


def apply(p: dict, x: torch.Tensor, cfg: dict, prec) -> torch.Tensor:
    x = attend(p, x, cfg, prec)
    b, t, d = x.shape
    h = prec(rmsnorm(x, p["ln_moe.scale"], cfg["norm_eps"])).reshape(-1, d)
    probs = torch.softmax(torch.matmul(h, prec(p["moe.router"])), dim=-1)
    order = torch.sort(probs, dim=-1, descending=True, stable=True).indices
    chosen = torch.zeros_like(probs, dtype=torch.bool).scatter_(
        1, order[:, :cfg["moe_top_k"]], True)
    y = swiglu(h, p["moe.shared.w_up"], p["moe.shared.w_down"],
               p["moe.shared.w_gate"], prec)
    first = cfg["expert_offset"]
    for e in range(cfg["n_experts"]):
        rows = torch.nonzero(chosen[:, first + e])[:, 0]
        out = swiglu(h[rows], p["moe.w_up"][e], p["moe.w_down"][e],
                     p["moe.w_gate"][e], prec)
        y = y.index_add(0, rows, out * probs[rows, first + e, None])
    return x + y.reshape(b, t, d)
