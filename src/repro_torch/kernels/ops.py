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
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import cost_model
from repro_torch.core.cost_model import JobParams
from repro_torch.kernels import cim_matmul as _cm
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ref
from repro_torch.kernels import selective_scan as _ss
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
                     causal: bool = True, bq: int = 128,
                     bk: int = 128) -> torch.Tensor:
    """Softmax attention of ``q`` [BH, T, d] over ``k``, ``v`` [BH, S, d]
    with ``bq`` x ``bk`` tiles; causal is top-left."""
    _fa.check_tiling(bq, bk)
    if _route(q) == "cpu":
        return ref.attention_ref(q, k, v, causal=causal)
    out = _fa.launch(q, k, v, causal=causal, bq=bq, bk=bk)
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
