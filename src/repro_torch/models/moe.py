"""Mixture-of-Experts block: top-k router + capacity-based scatter dispatch,
the reference's ``models/moe.py`` in PyTorch.

Tokens are scattered into a per-expert slot buffer [E, C, d] (C =
capacity), experts run as one batched einsum, and results are gathered
back with router weights.  Choices past an expert's capacity are dropped
in token order (the residual path carries them).  The top-k keeps
``jax.lax.top_k``'s order, ties to the lower expert index, so each
expert sees the reference's tokens.

:func:`moe_apply_held` is the port's own layer for one chip's share of an
expert-parallel deployment (DeepSeek-V2's MoE): the router scores all of
the layer's experts, the chip holds a run of them, and only the (token,
choice) pairs that land on those are computed, grouped by expert in a
product whose bounds stay on the card, with none dropped; shared experts
see every token.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import (COMPUTE_DTYPE, dense_init, gelu,
                                       mlp_apply, normal, silu)
from repro_torch.models import sharding as sh
from repro_torch.models.sharding import Identity
from repro_torch.obs import metrics as _metrics
from repro_torch.obs.trace import span

#: (token, choice) pairs routed to each held expert in forward passes, by
#: its index among the router's experts; counted on the card and added
#: here by :func:`flush_expert_pairs`
EXPERT_PAIRS = _metrics.registry().counter(
    "cim_moe_expert_pairs_total",
    "Routed (token, choice) pairs computed by each held expert",
    ("expert",))


def moe_params(gen, d_model: int, d_ff: int, n_experts: int,
               gated: bool = True, n_routed: int | None = None) -> dict:
    """The router [D, n_routed] (``n_experts`` where None) and the
    ``n_experts`` experts held here."""
    s_in = 1.0 / math.sqrt(d_model)
    s_ff = 1.0 / math.sqrt(d_ff)
    p = {
        "router": dense_init(gen, d_model, n_routed or n_experts),
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


def _gates(logits: torch.Tensor, top: int, renorm: bool = True):
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = top_k(probs, top)
    if renorm:
        gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                            min=1e-9)
    return probs, gate_vals, gate_idx


def _balance_loss(probs: torch.Tensor, first: torch.Tensor) -> torch.Tensor:
    """Switch-style load balance over ``probs`` [N, E] and each token's
    first choice ``first`` [N]."""
    n_exp = probs.shape[-1]
    # each expert's share of first choices, counted without ``one_hot``'s
    # range check, which reads the data on the host
    ce = probs.new_zeros(n_exp).scatter_add_(
        0, first, probs.new_ones(first.shape)) / first.numel()
    return n_exp * torch.sum(probs.mean(dim=0) * ce)


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
    aux = _balance_loss(probs, gate_idx[:, 0])

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


#: each held expert's rows are padded to a multiple of this with one zero
#: row at least (the grouped product's alignment)
ALIGN = 16


def _layout(gate_idx: torch.Tensor, n_held: int, offset: int, n_tok: int):
    """Where each (token, choice) pair of ``gate_idx`` [N, k] goes in the
    held experts' grouped rows, all on the device and of static shape.

    The pairs on held experts are sorted by expert (stable: token order
    within one); expert e's run takes rows ``ends[e] - padded[e]`` on,
    padded to a multiple of :data:`ALIGN` with one row at least.  Returns
    (src [R]: the token each row reads; valid [R]: whether it holds a
    pair; pos [N * k]: the row each pair's output is read from; held
    [N * k]; ends [n_held] int32, the groups' ends; sizes [n_held], their
    pairs).  R, ``N * min(k, n_held)`` pairs and the padding, bounds every
    routing, so none is dropped.  The rows that hold no pair read, and the
    pairs on no held expert are read from, rows spread over the tokens
    and the computed rows: no row gathers or scatters the gradients of
    many (an index's backward takes its repeats one by one)."""
    n_pairs = gate_idx.numel()
    dev = gate_idx.device
    local = gate_idx.reshape(-1) - offset
    held = (local >= 0) & (local < n_held)
    run, order = torch.sort(torch.where(held, local, n_held), stable=True)
    starts = torch.searchsorted(
        run, torch.arange(n_held + 1, device=dev, dtype=run.dtype))
    sizes = starts[1:] - starts[:-1]
    padded = (sizes // ALIGN + 1) * ALIGN
    ends = torch.cumsum(padded, 0)
    expert = run.clamp(max=n_held - 1)
    rank = torch.arange(n_pairs, device=dev)
    slot = rank - starts[expert] + (ends - padded)[expert]
    n_rows = gate_idx.shape[0] * min(gate_idx.shape[1], n_held) \
        + ALIGN * n_held
    held_sorted = run < n_held
    dest = torch.where(held_sorted, slot, n_rows)
    src = torch.arange(n_rows + 1, device=dev) % n_tok
    src.scatter_(0, dest, order // gate_idx.shape[1])
    valid = torch.zeros(n_rows + 1, dtype=torch.bool, device=dev)
    valid.scatter_(0, dest, held_sorted)
    pos = torch.empty_like(order).scatter_(
        0, order, torch.where(held_sorted, slot, rank % ends[-1]))
    return src[:n_rows], valid[:n_rows], pos, held, ends.to(torch.int32), \
        sizes


#: (token, choice) pairs routed to each held expert that the card has
#: counted and the counter not yet taken, by (offset, device)
_PENDING: dict[tuple, torch.Tensor] = {}


def flush_expert_pairs() -> None:
    """Add the card's pending counts to :data:`EXPERT_PAIRS`; this reads
    them on the host, so a reader calls it, never the step."""
    while _PENDING:
        (offset, _), counts = _PENDING.popitem()
        for e, n in enumerate(counts.tolist()):
            EXPERT_PAIRS.inc(n, expert=str(offset + e))


def moe_apply_held(
    p,
    x: torch.Tensor,              # [B, T, D]
    *,
    top_k: int,
    offset: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One chip's share of an expert-parallel MoE layer of SwiGLU experts,
    dropless, as DeepSeek-V2's: the top-k gates are the softmax's values,
    not renormalised.

    The router ``p["router"]`` [D, E] scores all E experts; this chip
    holds ``p["w_*"]`` [n, ...], experts ``offset`` to ``offset + n - 1``.
    The rows of the pairs on held experts are gathered grouped by expert
    (:func:`_layout`), each group multiplied by its expert's weights in
    one grouped product whose bounds stay on the card, and the outputs
    weighted by the gate and summed back per token in fp32.  Nothing is
    read on the host, however unevenly the pairs fall; every pair is
    computed.  ``p["shared"]``, where present, is a SwiGLU every token
    passes through, added to the routed sum.  Returns (output [B, T, D],
    the Switch-style balance loss over all E experts).
    """
    b, t, d = x.shape
    n_held = p["w_up"].shape[0]
    xt = x.reshape(b * t, d)
    cd = COMPUTE_DTYPE
    with span("moe.route"):
        logits = xt.float() @ p["router"].float()
        probs, gate_vals, gate_idx = _gates(logits, top_k, renorm=False)
        aux = _balance_loss(probs, gate_idx[:, 0])
    with span("moe.shared"):
        shared = mlp_apply(p["shared"], x, "swiglu") if "shared" in p \
            else None
    with span("moe.dispatch"):
        src, valid, pos, held, ends, sizes = _layout(gate_idx, n_held,
                                                     offset, b * t)
        if torch._C._current_graph_task_id() == -1:   # not the recompute
            key = (offset, x.device)
            _PENDING[key] = _PENDING.get(key, 0) + sizes
        # a row that holds no pair is zero, and its gradient (past the last
        # group's end the grouped product's is left unwritten) goes nowhere
        rows = torch.where(valid[:, None], xt.to(cd)[src], 0)
    with span("moe.experts"):
        # group e's rows times expert e's weights, the groups' ends read on
        # the card; rows past the last end are left unwritten
        gmm = lambda a, w: torch._grouped_mm(a, w.to(cd), offs=ends)
        h = F.silu(gmm(rows, p["w_gate"])) * gmm(rows, p["w_up"])
        out = gmm(h, p["w_down"])
    with span("moe.combine"):
        gate = torch.where(held, gate_vals.reshape(-1), 0.0)
        y = (out[pos] * gate[:, None]).reshape(b * t, top_k, d).sum(1)
        y = y.reshape(b, t, d).to(x.dtype)
        if shared is not None:
            y = shared + y
    return y, aux
