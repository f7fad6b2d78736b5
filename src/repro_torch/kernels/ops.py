"""Public wrappers of the port's kernels.

A wrapper takes its kernel's plain version (``ref.py``) only for tensors
that lie on the CPU; for a CUDA tensor it launches the hand-written kernel
or raises.  Each wrapper counts its kernel launches in a plain integer
attribute, ``<wrapper>.launches``, so a run can show that its main path
went through the kernel.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import cost_model
from repro_torch.core.cost_model import JobParams
from repro_torch.kernels import ref
from repro_torch.kernels import strategy_eval as _se


def _route(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no strategy_eval route for device {t.device}")
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


def strategy_eval(candidates: torch.Tensor, ops_arr: torch.Tensor, macro, *,
                  objective: str = "ee", strategy_set: str = "st",
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


strategy_eval.launches = 0
