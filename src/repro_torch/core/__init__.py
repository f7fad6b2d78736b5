"""CIM-Tuner core on PyTorch: hardware-mapping co-exploration for SRAM-CIM
accelerators.

Public API:
    MacroSpec / MACRO_LIBRARY       -- matrix abstraction of CIM macros
    AcceleratorConfig               -- generalized accelerator template point
    MatmulOp / Workload             -- operator IR (+ size-aware merging)
    Strategy / ALL_STRATEGIES       -- two-level mapping strategy space
    matmul_cost / workload_cost     -- closed-form tensor cost model
    compile_schedule / compile_trace / replay_trace -- instruction flows
    simulate_schedule               -- cycle simulator (closed form; card
                                       or CPU)
    co_explore / evaluate_config    -- the co-exploration tool
    CostModel / fit_corrections     -- the calibration tier (measured
                                       kernel timings -> energy factors)
    ExplorationEngine / ExploreJob  -- batched multi-job engine (the
                                       strategy_eval CUDA kernel on the card)
    valid_methods                   -- the search backends + "exhaustive"
    simulated_annealing / exhaustive_search -- the single-job search API
    distributed_co_explore          -- the population over a mesh of
                                       device slots

``repro.core``'s ``enable_persistent_compilation_cache`` is a JAX shim and
has no twin here.
"""
from repro_torch.core.annealing import (SASettings, exhaustive_search,
                                        simulated_annealing)
from repro_torch.core.calibration import (
    CALIBRATION_ENV,
    DEFAULT_TECH,
    CorrectionFactors,
    CostModel,
    TechConstants,
    calibration_version,
    default_cost_model,
    fit_corrections,
    fit_report,
    load_calibration,
    reset_default_cost_model,
    resolve_tech,
    save_calibration,
)
from repro_torch.core.compiler import (
    compile_schedule,
    compile_trace,
    replay_trace,
    schedule_totals,
    strategy_feasible,
)
from repro_torch.core.cost_model import (
    CostBreakdown,
    matmul_cost,
    strategy_table,
    workload_cost,
    workload_metrics,
)
from repro_torch.core.distributed import (DistributedResult,
                                          distributed_co_explore)
from repro_torch.core.engine import (ExplorationEngine, ExploreJob,
                                     default_engine, job_key, valid_methods)
from repro_torch.core.explorer import (ExploreResult, co_explore,
                                       co_explore_macros, evaluate_config,
                                       pareto_explore)
from repro_torch.core.ir import MatmulOp, Workload, bert_large_workload
from repro_torch.core.macro import MACRO_LIBRARY, MacroSpec, get_macro
from repro_torch.core.pruning import DesignSpace, prune_space
from repro_torch.core.simulator import (analytic_latency_bounds,
                                        simulate_schedule)
from repro_torch.core.strategies import ALL_STRATEGIES, SPATIAL_ONLY, Strategy
from repro_torch.core.template import AcceleratorConfig, accelerator_area_mm2

__all__ = [
    "DEFAULT_TECH", "TechConstants",
    "CostModel", "CorrectionFactors", "CALIBRATION_ENV",
    "default_cost_model", "reset_default_cost_model", "resolve_tech",
    "calibration_version", "fit_corrections", "fit_report",
    "save_calibration", "load_calibration",
    "MacroSpec", "MACRO_LIBRARY", "get_macro",
    "AcceleratorConfig", "accelerator_area_mm2",
    "MatmulOp", "Workload", "bert_large_workload",
    "Strategy", "ALL_STRATEGIES", "SPATIAL_ONLY",
    "CostBreakdown", "matmul_cost", "strategy_table", "workload_cost",
    "workload_metrics",
    "compile_schedule", "compile_trace", "replay_trace", "schedule_totals",
    "strategy_feasible",
    "simulate_schedule", "analytic_latency_bounds",
    "DesignSpace", "prune_space",
    "SASettings", "simulated_annealing", "exhaustive_search",
    "co_explore", "co_explore_macros", "pareto_explore",
    "evaluate_config", "ExploreResult",
    "ExplorationEngine", "ExploreJob", "default_engine",
    "job_key", "valid_methods",
    "distributed_co_explore", "DistributedResult",
]
