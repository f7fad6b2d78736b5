"""Plain PyTorch versions of the port's kernels (the correctness ground
truth): the same functions, written as plain tensor code."""
from __future__ import annotations

import math

import torch

from repro_torch.core import cost_model
from repro_torch.core.cost_model import JobParams


def strategy_eval_ref(candidates, ops_arr, macro, *, objective="ee",
                      strategy_set="st", tech=None) -> torch.Tensor:
    """Best-strategy objective of each candidate row [C, 6] of one job
    (operators [P, 5]; no area penalty), INFEASIBLE where the bandwidth
    rule fails -- the reference kernel's function."""
    lat, en, _ = cost_model.workload_cost(
        ops_arr, candidates, macro, tech, objective, strategy_set)
    val = cost_model.objective_value(lat, en, objective)
    return torch.where(cost_model.bandwidth_ok_t(candidates, macro), val,
                       cost_model.INFEASIBLE)


def job_objective_ref(job: JobParams, cand: torch.Tensor,
                      penalty_scale: float = 1e3, *, totals: bool = False):
    """The batched engine objective [J, C] of ``cand`` [J, C, 6]; with
    ``totals`` also the total latency and energy [J, C] and the
    per-operator strategy index [J, C, P] (int32), as the kernel returns
    them."""
    val, lat, en, idx = cost_model.job_terms(job, cand, penalty_scale)
    return (val, lat, en, idx.to(torch.int32)) if totals else val


def matmul_ref(a: torch.Tensor, b: torch.Tensor, out_dtype=None, *,
               tiling: str = "AF", bk: int = 128) -> torch.Tensor:
    """``a`` [M, K] @ ``b`` [K, N] computed in float32, in ``out_dtype``
    (default a's dtype).

    ``tiling="AF"`` rounds once, at the end.  ``tiling="PF"`` is the PF
    schedule's arithmetic: the float32 partial sum of each ``bk``-wide
    block of K is rounded to the output dtype and added to the output at
    that dtype, block after block, as the reference's ``_kernel_pf``
    does; in bfloat16 it is therefore less accurate than AF."""
    out_dtype = out_dtype or a.dtype
    a32, b32 = a.to(torch.float32), b.to(torch.float32)
    if tiling == "AF":
        return (a32 @ b32).to(out_dtype)
    if tiling != "PF":
        raise ValueError(f"tiling must be AF or PF, got {tiling!r}")
    out = None
    for k0 in range(0, a.shape[1], bk):
        part = (a32[:, k0:k0 + bk] @ b32[k0:k0 + bk]).to(out_dtype)
        out = part if out is None else \
            (out.to(torch.float32) + part.to(torch.float32)).to(out_dtype)
    if out is None:
        out = torch.zeros((a.shape[0], b.shape[1]), dtype=out_dtype,
                          device=a.device)
    return out


def _wide(x: torch.Tensor) -> torch.dtype:
    """The type the plain versions compute in: float32, or float64 for
    float64 inputs (the gradient checks run there)."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True) -> torch.Tensor:
    """Naive softmax attention in float32 (float64 for float64 inputs),
    out in q's dtype.  q [BH, T, d], k, v [BH, S, d]; causal masks key j
    for query i when j > i (top-left) with -1e30."""
    d = q.shape[-1]
    f = _wide(q)
    s = torch.einsum("btd,bsd->bts", q.to(f), k.to(f)) / math.sqrt(d)
    if causal:
        t, s_len = s.shape[-2], s.shape[-1]
        keep = torch.arange(s_len, device=q.device)[None, :] <= \
            torch.arange(t, device=q.device)[:, None]
        s = torch.where(keep[None], s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bts,bsd->btd", p, v.to(f)).to(q.dtype)


def selective_scan_ref(xi, dt, bmat, cmat, a, h0):
    """The Mamba-1 recurrence in float32 (float64 for float64 inputs), one
    time step after another: ``h = exp(dt a) h + (dt xi) B_t``,
    ``y_t = h . C_t``.  xi, dt [B, T, I], bmat, cmat [B, T, S], a [I, S],
    h0 [B, I, S].  Returns (y [B, T, I] in xi's dtype, h_last [B, I, S] in
    h0's dtype)."""
    f = _wide(xi)
    xi32, dt32 = xi.to(f), dt.to(f)
    b32, c32, a32 = bmat.to(f), cmat.to(f), a.to(f)
    h = h0.to(f)
    ys = []
    for t in range(xi.shape[1]):
        da = torch.exp(dt32[:, t, :, None] * a32[None])
        dbx = (dt32[:, t] * xi32[:, t])[:, :, None] * b32[:, t, None, :]
        h = da * h + dbx
        ys.append((h * c32[:, t, None, :]).sum(-1))
    y = torch.stack(ys, dim=1) if ys else torch.zeros_like(xi32)
    return y.to(xi.dtype), h.to(h0.dtype)


def attention_lse_ref(q: torch.Tensor, k: torch.Tensor, *,
                      causal: bool = True) -> torch.Tensor:
    """Each query row's log-sum-exp of its scaled, masked scores (masked
    with -1e30 as :func:`attention_ref`), float32 [BH, T]: what the
    ``flash_attention`` kernel writes for the backward pass."""
    d = q.shape[-1]
    f = _wide(q)
    s = torch.einsum("btd,bsd->bts", q.to(f), k.to(f)) / math.sqrt(d)
    if causal:
        t, s_len = s.shape[-2], s.shape[-1]
        keep = torch.arange(s_len, device=q.device)[None, :] <= \
            torch.arange(t, device=q.device)[:, None]
        s = torch.where(keep[None], s, torch.full_like(s, -1e30))
    return torch.logsumexp(s, dim=-1)


def _vjp(fn, inputs: tuple, cotangents: tuple) -> tuple:
    """The gradients of ``fn(*inputs)``'s outputs against ``cotangents``
    with respect to each input, by autograd on detached copies."""
    with torch.enable_grad():
        xs = tuple(x.detach().requires_grad_() for x in inputs)
        outs = fn(*xs)
        outs = outs if isinstance(outs, tuple) else (outs,)
        return torch.autograd.grad(outs, xs, cotangents, allow_unused=True)


def attention_bwd_ref(q, k, v, do, *, causal: bool = True):
    """(dq, dk, dv) of :func:`attention_ref` against the output gradient
    ``do``, in the inputs' dtypes: autograd of the plain version (the
    ``flash_attention_bwd`` kernel's function; it needs no ``o`` or
    log-sum-exp)."""
    return _vjp(lambda q_, k_, v_: attention_ref(q_, k_, v_, causal=causal),
                (q, k, v), (do,))


def selective_scan_bwd_ref(xi, dt, bmat, cmat, a, h0, dy, dh_last):
    """(dxi, ddt, dB, dC, da, dh0) of :func:`selective_scan_ref` against
    the gradients ``dy`` of y and ``dh_last`` of h_last: autograd of the
    plain version (the ``selective_scan_bwd`` kernel's function)."""
    return _vjp(selective_scan_ref, (xi, dt, bmat, cmat, a, h0),
                (dy, dh_last))


def adamw_sumsq_ref(grads) -> torch.Tensor:
    """Each leaf's fp32 sum of squares, [L] (the ``adamw`` kernels' norm
    pass)."""
    return torch.stack([torch.sum(torch.square(g.float())) for g in grads])


def adamw_norm_ref(sums: torch.Tensor) -> torch.Tensor:
    """sqrt of the leaves' sums added in leaf order (Python's ``sum``,
    from 0)."""
    return torch.sqrt(sum(sums.unbind()))


def adamw_apply_ref(params, grads, ms, vs, decay, gnorm, *, lr, b1c, b2c,
                    b1: float, b2: float, eps: float, weight_decay: float,
                    grad_clip: float) -> None:
    """AdamW's clipped update, leaf by leaf, in place (the ``adamw``
    kernel's function): the clip scale from the global norm ``gnorm``, then
    each leaf in the reference's order, every operation one fp32 kernel;
    ``decay`` a flag a leaf, ``lr``, ``b1c`` and ``b2c`` 0-dim fp32
    tensors.  The transient memory is one leaf's."""
    scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
    for p, g, m, v, d in zip(params, grads, ms, vs, decay):
        g = g.float() * scale
        # the reference's order: b1 m + ((1 - b1) g),
        # b2 v + ((1 - b2) g) g
        m.mul_(b1).add_(g * (1 - b1))
        v.mul_(b2).add_((g * (1 - b2)).mul_(g))
        upd = (m / b1c).div_(torch.sqrt(v / b2c).add_(eps))
        if d:                          # no decay on norms / biases
            upd.add_(weight_decay * p.float())
        p.copy_(p.float() - lr * upd)
        del g, upd
