"""Public wrappers of the port's kernels.

A wrapper takes its kernel's plain version (``ref.py``) only for tensors
that lie on the CPU; for a CUDA tensor it launches the hand-written kernel
or raises.  Each wrapper counts its kernel launches in a plain integer
attribute, ``<wrapper>.launches``, so a run can show that its main path
went through the kernel.

``cim_matmul``, ``flash_attention``, ``selective_scan`` and
``strategy_eval`` keep the reference's signatures and shape-bucket labels
and are wrapped by :func:`repro_torch.obs.profile.instrument`: with
``CIM_TUNER_PROFILE`` set, every call is timed to completion and recorded
into the ``cim_kernel_*`` metric families per (kernel, shape bucket).
``job_objective`` is the engine's batched evaluator.

Training differentiates through two of them: ``flash_attention_bwd`` and
``selective_scan_bwd`` are the wrappers of their hand-written backward
kernels (:data:`BACKWARD_WRAPPERS`), and :class:`FlashAttention` and
:class:`SelectiveScan` are the ``torch.autograd.Function``s whose forward
and backward launch the kernels on the card (and run the plain versions,
the backward by autograd of them, on the CPU).
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import cost_model
from repro_torch.core.cost_model import JobParams
from repro_torch.kernels import cim_matmul as _cm
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import flash_attention_bwd as _fab
from repro_torch.kernels import ref
from repro_torch.kernels import selective_scan as _ss
from repro_torch.kernels import selective_scan_bwd as _ssb
from repro_torch.kernels import strategy_eval as _se
from repro_torch.obs import profile as _profile


def _route(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel route for device {t.device}")
    return t.device.type


def job_objective(job: JobParams, cand: torch.Tensor,
                  penalty_scale: float = 1e3, *, totals: bool = False):
    """The engine's batched objective [J, C] of ``cand`` [J, C, 6] (area
    penalty and bandwidth rule included); with ``totals`` also the total
    latency and energy [J, C] and the per-operator strategy index
    [J, C, P] (int32)."""
    if _route(cand) == "cpu":
        return ref.job_objective_ref(job, cand, penalty_scale, totals=totals)
    out = _se.launch(cand, job.ops, _se.pack_params(job), penalty_scale,
                     totals=totals)
    job_objective.launches += 1
    return out


job_objective.launches = 0


def objective_fn(job: JobParams, penalty_scale: float = 1e3):
    """One job's objective ``cfg [..., 6] -> [...]`` through
    :func:`job_objective` (one ``strategy_eval`` launch per call on the
    card): the batched objective the single-job SA and exhaustive APIs of
    ``core/annealing.py`` take.  ``job`` has one job (J = 1)."""
    if job.ops.shape[0] != 1:
        raise ValueError(f"objective_fn takes one job, got {job.ops.shape[0]}")

    def fn(cfg: torch.Tensor) -> torch.Tensor:
        flat = cfg.reshape(1, -1, cfg.shape[-1]).contiguous()
        return job_objective(job, flat, penalty_scale).reshape(cfg.shape[:-1])
    return fn


def _strategy_eval(candidates: torch.Tensor, ops_arr: torch.Tensor, macro,
                   *, objective: str = "ee", strategy_set: str = "st",
                   tech=None) -> torch.Tensor:
    """Best-strategy objective [C] of candidate rows [C, 6] of one job with
    operators [P, 5] (no area penalty) -- the reference kernel's
    signature."""
    if _route(candidates) == "cpu":
        return ref.strategy_eval_ref(candidates, ops_arr, macro,
                                     objective=objective,
                                     strategy_set=strategy_set, tech=tech)
    dtype, device = candidates.dtype, candidates.device
    # an unbounded budget makes the area penalty exactly 1
    job = cost_model.stack_job_params(
        [cost_model.job_params_np(ops_arr.cpu().numpy(), macro, tech,
                                  objective, strategy_set, math.inf, 0.0)],
        dtype, device)
    out = _se.launch(candidates[None].contiguous(), job.ops,
                     _se.pack_params(job), 0.0)[0]
    strategy_eval.launches += 1
    return out


def _cim_matmul(a: torch.Tensor, b: torch.Tensor, *, tiling: str = "AF",
                bm: int = _cm.DEFAULT_BM, bn: int = _cm.DEFAULT_BN,
                bk: int = _cm.DEFAULT_BK) -> torch.Tensor:
    """``a`` [M, K] @ ``b`` [K, N] in a's dtype under the AF or PF
    schedule with ``bm x bn x bk`` blocks."""
    _cm.check_tiling(tiling, bm, bn, bk)
    if _route(a) == "cpu":
        return ref.matmul_ref(a, b, tiling=tiling, bk=bk)
    out = _cm.launch(a, b, tiling=tiling, bm=bm, bn=bn, bk=bk)
    cim_matmul.launches += 1
    return out


def _flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     causal: bool = True, bq: int | None = None,
                     bk: int | None = None, return_lse: bool = False):
    """Softmax attention of ``q`` [BH, T, d] over ``k``, ``v`` [BH, S, d]
    with ``bq`` x ``bk`` tiles (where None, the kernel's default for the
    head width: 128 x 128 up to width 128, 64 x 64 at 256); causal is
    top-left.  With ``return_lse``, (out, the rows' log-sum-exp [BH, T]
    float32)."""
    _fa.check_tiling(bq, bk)
    if _route(q) == "cpu":
        out = ref.attention_ref(q, k, v, causal=causal)
        return (out, ref.attention_lse_ref(q, k, causal=causal)) \
            if return_lse else out
    out = _fa.launch(q, k, v, causal=causal, bq=bq, bk=bk,
                     return_lse=return_lse)
    flash_attention.launches += 1
    return out


def _selective_scan(xi, dt, bmat, cmat, a, h0, *, ct: int = _ss.DEFAULT_CT,
                    ci: int = _ss.DEFAULT_CI):
    """The Mamba-1 scan; returns (y [B, T, I], h_last [B, I, S])."""
    _ss.check_tiling(ct, ci)
    if _route(xi) == "cpu":
        return ref.selective_scan_ref(xi, dt, bmat, cmat, a, h0)
    out = _ss.launch(xi, dt, bmat, cmat, a, h0, ct=ct, ci=ci)
    selective_scan.launches += 1
    return out


def flash_attention_bwd(q, k, v, do, lse, *, causal: bool = True):
    """(dq, dk, dv) of :func:`flash_attention` against its output's
    gradient ``do``, given the forward's log-sum-exp ``lse`` (bf16 on the
    card; the plain version needs no ``lse``).  One call counts one launch
    (the kernel is two launches on the card)."""
    if _route(q) == "cpu":
        return ref.attention_bwd_ref(q, k, v, do, causal=causal)
    out = _fab.launch(q, k, v, do, lse, causal=causal)
    flash_attention_bwd.launches += 1
    return out


def selective_scan_bwd(xi, dt, bmat, cmat, a, h0, dy, dh_last):
    """(dxi, ddt, dB, dC, da, dh0) of :func:`selective_scan` against the
    gradients ``dy`` of y and ``dh_last`` of h_last (float32 on the card).
    One call counts one launch (the kernel is four launches on the card)."""
    if _route(xi) == "cpu":
        return ref.selective_scan_bwd_ref(xi, dt, bmat, cmat, a, h0, dy,
                                          dh_last)
    out = _ssb.launch(xi, dt, bmat, cmat, a, h0, dy, dh_last)
    selective_scan_bwd.launches += 1
    return out


flash_attention_bwd.launches = 0
selective_scan_bwd.launches = 0


class FlashAttention(torch.autograd.Function):
    """Differentiable :func:`flash_attention` (``q`` [BH, T, d], ``k``,
    ``v`` [BH, S, d]): the forward kernel, which also writes the rows'
    log-sum-exp when a gradient is needed, and :func:`flash_attention_bwd`
    for the backward.  ``FlashAttention.apply(q, k, v, causal)``."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        ctx.causal = causal
        if not any(ctx.needs_input_grad[:3]):
            return flash_attention(q, k, v, causal=causal)
        out, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
        ctx.save_for_backward(q, k, v, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, do.contiguous(), lse,
                                         causal=ctx.causal)
        return dq, dk, dv, None


class SelectiveScan(torch.autograd.Function):
    """Differentiable :func:`selective_scan`:
    ``SelectiveScan.apply(xi, dt, bmat, cmat, a, h0)`` returns (y,
    h_last); the backward is :func:`selective_scan_bwd`."""

    @staticmethod
    def forward(ctx, xi, dt, bmat, cmat, a, h0):
        y, h_last = selective_scan(xi, dt, bmat, cmat, a, h0)
        if any(ctx.needs_input_grad):
            ctx.save_for_backward(xi, dt, bmat, cmat, a, h0)
        return y, h_last

    @staticmethod
    def backward(ctx, dy, dh_last):
        return selective_scan_bwd(*ctx.saved_tensors, dy.contiguous(),
                                  dh_last.contiguous())


# shape-bucket labels for the cim_kernel_* series (the reference's)
def _matmul_bucket(a, b, **kw):
    return f"{a.shape[0]}x{b.shape[1]}x{a.shape[1]}"


def _attn_bucket(q, k, v, **kw):
    return f"{q.shape[0]}x{q.shape[1]}x{k.shape[1]}x{q.shape[2]}"


def _strat_bucket(candidates, ops_arr, macro, **kw):
    return f"C{len(candidates)}xP{len(ops_arr)}"


def _scan_bucket(xi, dt, bmat, cmat, a, h0, **kw):
    return f"{xi.shape[0]}x{xi.shape[1]}x{xi.shape[2]}x{a.shape[1]}"


cim_matmul = _profile.instrument("cim_matmul", _cim_matmul, _matmul_bucket)
flash_attention = _profile.instrument("flash_attention", _flash_attention,
                                      _attn_bucket)
strategy_eval = _profile.instrument("strategy_eval", _strategy_eval,
                                    _strat_bucket)
selective_scan = _profile.instrument("selective_scan", _selective_scan,
                                     _scan_bucket)
for _wrapper in (cim_matmul, flash_attention, strategy_eval, selective_scan):
    _wrapper.launches = 0

#: the wrappers whose kernels the calibration path launches
KERNEL_WRAPPERS = {"cim_matmul": cim_matmul,
                   "flash_attention": flash_attention,
                   "selective_scan": selective_scan,
                   "strategy_eval": strategy_eval}
#: the wrappers of the backward kernels (the training path's)
BACKWARD_WRAPPERS = {"flash_attention_bwd": flash_attention_bwd,
                     "selective_scan_bwd": selective_scan_bwd}
