"""Plain PyTorch versions of the port's kernels (the correctness ground
truth): the same functions, written as tensor code on the cost model."""
from __future__ import annotations

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
