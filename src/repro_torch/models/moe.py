"""Mixture-of-Experts block: top-k router + capacity-based scatter dispatch,
the reference's ``models/moe.py`` in PyTorch.

Tokens are scattered into a per-expert slot buffer [E, C, d] (C =
capacity), experts run as one batched einsum, and results are gathered
back with router weights.  Choices past an expert's capacity are dropped
in token order (the residual path carries them).  The top-k keeps
``jax.lax.top_k``'s order, ties to the lower expert index, so each
expert sees the reference's tokens.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import COMPUTE_DTYPE, dense_init, gelu, normal, silu
from repro_torch.models import sharding as sh
from repro_torch.models.sharding import Identity


def moe_params(gen, d_model: int, d_ff: int, n_experts: int,
               gated: bool = True) -> dict:
    s_in = 1.0 / math.sqrt(d_model)
    s_ff = 1.0 / math.sqrt(d_ff)
    p = {
        "router": dense_init(gen, d_model, n_experts),
        "w_up": normal(gen, (n_experts, d_model, d_ff), s_in),
        "w_down": normal(gen, (n_experts, d_ff, d_model), s_ff),
    }
    if gated:
        p["w_gate"] = normal(gen, (n_experts, d_model, d_ff), s_in)
    return p


def top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k``: the k largest along the last axis, in descending
    order, ties to the lower index."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _gates(logits: torch.Tensor, top: int):
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = top_k(probs, top)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    return probs, gate_vals, gate_idx


def dispatch(gate_idx: torch.Tensor, n_exp: int, capacity: int):
    """Arrival-order slots of the (token, choice) pairs ``gate_idx``
    [..., N] (flattened in token order along the last axis): returns
    (keep [..., N], slot [..., N]); a dropped pair's slot is
    ``n_exp * capacity``."""
    onehot = F.one_hot(gate_idx, n_exp).to(torch.int32)
    pos = torch.cumsum(onehot, dim=-2) - 1                 # arrival order
    pos_in_expert = torch.gather(pos, -1, gate_idx[..., None])[..., 0]
    keep = pos_in_expert < capacity
    slot = gate_idx * capacity + pos_in_expert
    slot = torch.where(keep, slot, n_exp * capacity)       # drop -> spare
    return keep, slot


def _experts(p, buf: torch.Tensor, act: str, eq_in: str, eq_out: str):
    up = torch.einsum(eq_in, buf, p["w_up"].to(COMPUTE_DTYPE))
    if "w_gate" in p:
        g = torch.einsum(eq_in, buf, p["w_gate"].to(COMPUTE_DTYPE))
        g = silu(g) if act == "swiglu" else gelu(g)
        h = g * up
    else:
        h = gelu(up)
    return torch.einsum(eq_out, h, p["w_down"].to(COMPUTE_DTYPE))


def _replicated(fn, p, x, **kw):
    """``fn(p, x, **kw)`` -> (y, aux) on replicated local tensors."""
    keys = list(p._parameters) if isinstance(p, torch.nn.Module) else list(p)

    def local(x, *leaves):
        return fn(dict(zip(keys, leaves)), x, **kw)
    return sh.local_replicated(local, 2, x, *(p[k] for k in keys))


def moe_apply(
    p,
    x: torch.Tensor,              # [B, T, D]
    *,
    top_k: int,
    act: str = "swiglu",
    capacity_factor: float = 1.25,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (output [B, T, D], aux load-balancing loss scalar).  On a
    mesh it runs replicated (``sharding.local_replicated``)."""
    if sh.is_dtensor(x):
        return _replicated(moe_apply, p, x, top_k=top_k, act=act,
                           capacity_factor=capacity_factor)
    b, t, d = x.shape
    n_exp = p["router"].shape[1]
    xt = x.reshape(b * t, d)
    tokens = b * t

    logits = xt.float() @ p["router"].float()
    probs, gate_vals, gate_idx = _gates(logits, top_k)      # [T, k]

    # load-balancing aux loss (Switch-style)
    me = probs.mean(dim=0)
    ce = F.one_hot(gate_idx[:, 0], n_exp).float().mean(dim=0)
    aux = n_exp * torch.sum(me * ce)

    # capacity floor keeps small token counts fully dropless
    capacity = max(int(capacity_factor * tokens * top_k / n_exp),
                   min(tokens, 64), 1)
    keep, slot = dispatch(gate_idx.reshape(-1), n_exp, capacity)

    # scatter tokens into expert slots [E*C, D]
    xk = torch.repeat_interleave(xt, top_k, dim=0)          # token order
    buf = xt.new_zeros((n_exp * capacity + 1, d))
    buf[slot] = xk
    buf = buf[:-1].reshape(n_exp, capacity, d).to(COMPUTE_DTYPE)

    out_e = _experts(p, buf, act, "ecd,edf->ecf", "ecf,efd->ecd")

    # gather back with router weights
    out_flat = torch.cat([out_e.reshape(n_exp * capacity, d),
                          out_e.new_zeros((1, d))], dim=0)
    gathered = out_flat[slot]                               # [T*k, D]
    w = (gate_vals.reshape(-1) * keep).to(gathered.dtype)
    y = (gathered * w[:, None]).reshape(tokens, top_k, d).sum(dim=1)
    return y.reshape(b, t, d).to(x.dtype), aux


def moe_apply_row(
    p,
    x: torch.Tensor,              # [B, T, D]
    *,
    top_k: int,
    act: str = "swiglu",
    capacity_factor: float = 1.25,
    shard_act=Identity,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-batch-row-local dispatch: arrival order and capacity per row
    (cf * T * k / E), token rows gathered into the slot table; the expert
    buffers are pinned batch-sharded (``shard_act(.., "moe_buf")``).  On
    a mesh it runs replicated (``sharding.local_replicated``): the aux
    loss takes means over the whole batch."""
    if sh.is_dtensor(x):
        return _replicated(moe_apply_row, p, x, top_k=top_k, act=act,
                           capacity_factor=capacity_factor,
                           shard_act=shard_act)
    b, t, d = x.shape
    n_exp = p["router"].shape[1]

    logits = x.float() @ p["router"].float()
    probs, gate_vals, gate_idx = _gates(logits, top_k)      # [B, T, k]

    me = probs.mean(dim=(0, 1))
    ce = F.one_hot(gate_idx[..., 0], n_exp).float().mean(dim=(0, 1))
    aux = n_exp * torch.sum(me * ce)

    capacity = max(int(capacity_factor * t * top_k / n_exp), min(t, 64), 1)
    keep, slot = dispatch(gate_idx.reshape(b, t * top_k), n_exp, capacity)

    # scatter the assignment ids into the slot table, then gather rows
    n_assign = t * top_k
    ids = torch.full((b, n_exp * capacity + 1), n_assign, dtype=torch.int64,
                     device=x.device)
    ids.scatter_(1, slot, torch.arange(n_assign, device=x.device)
                 .expand(b, n_assign).contiguous())
    slot_assign = ids[:, :-1]                               # [B, E*C]
    token_of_slot = torch.clamp(slot_assign // top_k, max=t - 1)
    slot_valid = slot_assign < n_assign
    buf = torch.gather(x.to(COMPUTE_DTYPE), 1,
                       token_of_slot[..., None].expand(b, n_exp * capacity, d))
    buf = torch.where(slot_valid[..., None], buf, 0)
    buf = shard_act(buf.reshape(b, n_exp, capacity, d), "moe_buf")

    out_e = shard_act(_experts(p, buf, act, "becd,edf->becf",
                               "becf,efd->becd"), "moe_buf")

    out_flat = torch.cat([out_e.reshape(b, n_exp * capacity, d),
                          out_e.new_zeros((b, 1, d))], dim=1)
    gathered = torch.gather(out_flat, 1, slot[..., None].expand(b, t * top_k, d))
    w = (gate_vals.reshape(b, t * top_k) * keep).to(gathered.dtype)
    y = (gathered * w[..., None]).reshape(b, t, top_k, d).sum(dim=2)
    return y.to(x.dtype), aux
