"""Top-level hardware-mapping co-exploration API (paper Fig. 3).

``co_explore`` is the tool a designer calls: given a macro, a workload, an
area budget and an optimization target, it returns the optimal accelerator
sizing (MR, MC, SCR, IS_SIZE, OS_SIZE) together with the optimal per-operator
mapping strategy and PPA metrics.  Mapping exploration (the per-operator
8-strategy argmin) runs as a sub-process of hardware exploration, exactly as
in the paper's workflow.

The search method is pluggable (``repro_torch.search``): ``"sa"`` (the
paper's simulated annealing, vectorized chains), ``"genetic"``,
``"evolution"``, ``"sobol"``, ``"portfolio"`` (a bandit or
successive-halving race over those four, optionally with the
measured-fidelity rung), or ``"exhaustive"`` (ground truth over the
pruned space).  Backend-specific settings go in ``settings=`` (e.g.
``GASettings``); ``sa_settings`` remains the SA spelling.

``co_explore``, ``co_explore_macros`` and ``pareto_explore`` are thin
synchronous clients of the process-wide DSE service
(``repro_torch.service.default_service(device, dtype)``, ``cuda`` unless
the caller asks for ``"cpu"``): a call submits a batch, so repeated and
interleaved callers share one engine, identical in-flight submissions
dedup onto one evaluation, and repeated queries across processes hit the
persistent result store instead of re-running.  Passing ``engine=``
bypasses the service and dispatches directly on that engine (no queue,
no store) -- the escape hatch for benchmarking and for callers that
manage their own batches.  A result answered from the result store
is deserialized and carries ``.sa = None``, so whether ``.sa`` is set
depends on the store: read the search diagnostics from an ``engine=``
run.
``evaluate_config`` is one evaluator call on ``device``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import cost_model
from repro_torch.core.annealing import SASettings
from repro_torch.core.calibration import TechConstants, resolve_tech
from repro_torch.core.engine import (
    ExplorationEngine,
    ExploreJob,
    ExploreResult,
    resolve_device,
)
from repro_torch.core.ir import Workload
from repro_torch.core.macro import MacroSpec
from repro_torch.core.pruning import DesignSpace, candidates_with_bw, prune_space
from repro_torch.core.strategies import ALL_STRATEGIES
from repro_torch.core.template import AcceleratorConfig
from repro_torch.kernels import ops

__all__ = [
    "ExploreResult",
    "co_explore",
    "co_explore_macros",
    "pareto_explore",
    "pareto_frontier_from_values",
    "evaluate_config",
]


def _run_jobs(
    jobs: list[ExploreJob],
    method: str,
    sa_settings: SASettings | None,
    engine: ExplorationEngine | None,
    settings,
    device,
    dtype: torch.dtype,
) -> list[ExploreResult]:
    """Dispatch a job list: direct engine call when the caller supplied an
    engine, otherwise through the process-wide service for ``device`` and
    ``dtype`` (micro-batching, in-flight dedup, persistent result store)."""
    if settings is None and method == "sa":
        settings = sa_settings
    if engine is not None:
        return engine.run(jobs, method=method, settings=settings)
    from repro_torch.service.client import default_service
    return default_service(device, dtype).explore(jobs, method=method,
                                                  settings=settings)


def co_explore(
    macro: MacroSpec,
    workload: Workload,
    area_budget_mm2: float,
    objective: str = "ee",
    strategy_set: str = "st",
    method: str = "sa",
    space: DesignSpace | None = None,
    fixed: dict | None = None,
    bw: int = 256,
    tech: TechConstants | None = None,
    sa_settings: SASettings = SASettings(),
    merge_ops: bool = True,
    engine: ExplorationEngine | None = None,
    settings=None,
    device="cuda",
    dtype: torch.dtype = torch.float32,
) -> ExploreResult:
    """Single-job co-exploration (a batch of one through the service, or
    on ``engine``).

    ``method`` accepts a registered search backend name or
    ``"exhaustive"``; ``settings`` carries that backend's settings object
    (``sa_settings`` is the SA-specific spelling).
    """
    space = space or DesignSpace()
    if fixed:
        space = space.fix(**fixed)
    tech = resolve_tech(tech)
    job = ExploreJob(
        macro=macro, workload=workload, area_budget_mm2=area_budget_mm2,
        objective=objective, strategy_set=strategy_set, bw=bw, tech=tech,
        space=space, merge_ops=merge_ops, search_method=method,
    )
    return _run_jobs([job], method, sa_settings, engine, settings, device,
                     dtype)[0]


def co_explore_macros(
    macros: list[MacroSpec],
    workload: Workload,
    area_budget_mm2: float,
    engine: ExplorationEngine | None = None,
    device="cuda",
    dtype: torch.dtype = torch.float32,
    **kw,
) -> tuple[ExploreResult, list[ExploreResult]]:
    """Macro-library co-exploration: additionally selects the best macro
    *family* from a library under the same budget/objective.

    The per-macro jobs run as ONE engine batch (macro constants are per-job
    tensors), through the service unless ``engine`` is given.  Returns
    (best result, all per-macro results)."""
    objective = kw.get("objective", "ee")
    method = kw.pop("method", "sa")
    sa_settings = kw.pop("sa_settings", SASettings())
    settings = kw.pop("settings", None)
    space = kw.pop("space", None) or DesignSpace()
    fixed = kw.pop("fixed", None)
    if fixed:
        space = space.fix(**fixed)
    jobs = [
        ExploreJob(macro=m, workload=workload,
                   area_budget_mm2=area_budget_mm2, space=space,
                   search_method=method, **kw)
        for m in macros
    ]
    results = _run_jobs(jobs, method, sa_settings, engine, settings, device,
                        dtype)
    key = (lambda r: -r.metrics["tops_w"]) if objective == "ee" else \
        (lambda r: -r.metrics["gops"]) if objective == "th" else \
        (lambda r: r.metrics["latency_s"] * r.metrics["energy_pj"])
    best = min(results, key=key)
    return best, results


def pareto_explore(
    macro: MacroSpec,
    workload: Workload,
    area_budget_mm2: float,
    strategy_set: str = "st",
    space: DesignSpace | None = None,
    bw: int = 256,
    tech: TechConstants | None = None,
    engine: ExplorationEngine | None = None,
    device="cuda",
    dtype: torch.dtype = torch.float32,
) -> list[dict]:
    """Energy-efficiency vs throughput Pareto frontier over the pruned
    hardware space.  Returns frontier points sorted by throughput, each with
    config + metrics.

    Each metric gets its own best mapping (the per-operator argmin is
    objective-dependent), so this is a two-job engine batch -- "th" and
    "ee" sweep the same candidate list, as two ``values`` submissions to
    the service unless ``engine`` is given."""
    space = space or DesignSpace()
    tech = resolve_tech(tech)
    cands, _ = prune_space(space, macro, area_budget_mm2, bw, tech)
    if len(cands) == 0:
        raise ValueError("no feasible hardware point under budget")
    rows = candidates_with_bw(cands, bw)

    jobs = [
        ExploreJob(macro=macro, workload=workload,
                   area_budget_mm2=area_budget_mm2, objective=obj,
                   strategy_set=strategy_set, bw=bw, tech=tech, space=space)
        for obj in ("th", "ee")
    ]
    # pruned candidates respect budget+bandwidth, so the job objective
    # degenerates to exactly total latency ("th") / total energy ("ee")
    if engine is not None:
        lat, en = engine.candidate_values(jobs, [rows, rows])
    else:
        from repro_torch.service.client import default_service
        svc = default_service(device, dtype)
        futures = [svc.submit_values(j, rows) for j in jobs]
        lat, en = (np.asarray(f.result()) for f in futures)
    return pareto_frontier_from_values(cands, lat, en, workload, macro, bw)


def pareto_frontier_from_values(
    cands: np.ndarray,
    lat: np.ndarray,
    en: np.ndarray,
    workload: Workload,
    macro: MacroSpec,
    bw: int,
) -> list[dict]:
    """Frontier points (maximize GOPS and TOPS/W jointly) from per-candidate
    total latency / total energy sweeps."""
    wl = workload.merged()
    total_ops = float(wl.total_ops)
    gops = total_ops / (lat / (macro.freq_mhz * 1e6)) / 1e9
    tops_w = total_ops / (en * 1e-12) / 1e12

    order = np.argsort(-gops)
    frontier = []
    best_ee = -np.inf
    for i in order:
        if tops_w[i] > best_ee:
            best_ee = tops_w[i]
            frontier.append({
                "config": AcceleratorConfig(*[int(v) for v in cands[i]],
                                            bw=bw),
                "gops": float(gops[i]),
                "tops_w": float(tops_w[i]),
            })
    return frontier


def evaluate_config(
    macro: MacroSpec,
    cfg: AcceleratorConfig,
    workload: Workload,
    objective: str = "ee",
    strategy_set: str = "st",
    tech: TechConstants | None = None,
    device="cuda",
    dtype: torch.dtype = torch.float32,
) -> dict:
    """PPA of a *given* accelerator on a workload (used for the Table II
    baselines and for Fig. 8's fixed-hardware breakdowns); one evaluator
    call (one kernel launch on the card)."""
    dev = resolve_device(device)
    wl = workload.merged()
    ops_arr = wl.as_arrays()
    row = np.array([cfg.mr, cfg.mc, cfg.scr, cfg.is_kb, cfg.os_kb, cfg.bw],
                   dtype=np.float64)
    job = cost_model.stack_job_params(
        [cost_model.job_params_np(ops_arr, macro, tech, objective,
                                  strategy_set, np.inf, cfg.bw)],
        dtype, dev)
    cand = torch.as_tensor(row[None, None], dtype=dtype).to(dev)
    _, lat, en, idx = ops.job_objective(job, cand, totals=True)
    m = cost_model.metrics_from_totals(
        ops_arr, row, lat[0, 0].cpu(), en[0, 0].cpu(), idx[0, 0].cpu(),
        macro, tech)
    m["per_op_strategy"] = {
        op.name or f"op{i}": str(ALL_STRATEGIES[m["strategy_idx"][i]])
        for i, op in enumerate(wl.ops)
    }
    del m["strategy_idx"]
    return m
