"""Batched multi-job hardware-mapping co-exploration engine.

The engine runs whole job lists through one batched objective:

1. **Shape bucketing** -- each job's merged operator array is padded to a
   power-of-two width (padded rows carry ``count == 0`` and are
   cost-transparent), so heterogeneous jobs share one ``[J, P, 5]`` tensor.
2. **Job stacking** -- macro/tech constants, strategy masks, objective
   codes, area budgets and bus widths become per-job tensors
   (:class:`repro_torch.core.cost_model.JobParams`).  Exhaustive sweeps
   evaluate a ``[jobs, chunk]`` candidate block per call, and every SA step
   evaluates the ``[jobs, chains]`` proposals in one call.
3. **The evaluator** -- that call is ``kernels.ops.job_objective``: on the
   card it launches the hand-written ``strategy_eval`` CUDA kernel, on the
   CPU it runs the kernel's plain PyTorch version.  The winners' metrics
   and per-operator strategies come from one more launch on the winning
   rows.

The search method is pluggable (``repro_torch.search``): ``"sa"``,
``"genetic"``, ``"evolution"`` and ``"sobol"`` run one batched backend
call per (bucket, settings) group, every step of every job one evaluator
call; the composite ``"portfolio"`` races them per job under a bandit
(UCB) or successive-halving budget allocator
(:meth:`ExplorationEngine._run_portfolio_batch`), with an optional
measured-fidelity rung; ``"exhaustive"`` sweeps the pruned space.

The engine runs on ``cuda`` unless the caller asks for ``device="cpu"``; a
``cuda`` engine on a host without a card raises.  ``dtype`` is
``torch.float32`` by default and ``torch.float64`` for exact integer
semantics (the reference's x64 mode).

Identical jobs inside one ``run()`` (same canonical :func:`job_key`)
evaluate once and fan the result out.  ``co_explore`` /
``co_explore_macros`` / ``pareto_explore`` (``core/explorer.py``) reach
this engine through the DSE service (``repro_torch.service``), whose
queue groups submissions by :meth:`ExplorationEngine.bucket_key` and
dispatches one ``run()`` per bucket; given ``engine=``, they call it
directly.
"""
from __future__ import annotations

import copy
import dataclasses
import hashlib
import json
import time
import typing

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import cost_model
from repro_torch.core.annealing import SASettings, _axes_matrix
from repro_torch.core.calibration import DEFAULT_TECH, TechConstants
from repro_torch.core.ir import Workload
from repro_torch.core.macro import MacroSpec
from repro_torch.core.pruning import DesignSpace, candidates_with_bw, prune_space
from repro_torch.core.strategies import ALL_STRATEGIES
from repro_torch.core.template import AcceleratorConfig, accelerator_area_mm2
from repro_torch.kernels import ops
from repro_torch.search.base import (SearchResult, available_backends,
                                     get_backend)

__all__ = [
    "ExploreJob",
    "ExploreResult",
    "ExplorationEngine",
    "default_engine",
    "job_key",
    "preferred_settings",
    "resolve_device",
    "valid_methods",
]


# --------------------------------------------------------------------- #
# telemetry families (process-wide, the reference's names)
# --------------------------------------------------------------------- #
_REG = obs.registry()
_LOG = obs.get_logger("engine")
_M_JOBS = _REG.counter(
    "cim_engine_jobs_total", "Jobs submitted to ExplorationEngine.run")
_M_BATCHES = _REG.counter(
    "cim_engine_batches_total", "Batched evaluator dispatches")
_M_DEDUP = _REG.counter(
    "cim_engine_dedup_hits_total",
    "In-batch duplicate jobs folded into one evaluation")
_M_RACE = _REG.counter(
    "cim_engine_device_race_dispatches_total",
    "Portfolio backend runs placed on an explicit race device")
_M_RUN_S = _REG.histogram(
    "cim_engine_run_seconds", "Wall-clock of ExplorationEngine.run calls")
_M_PULLS = _REG.counter(
    "cim_search_pulls_total",
    "Portfolio pulls granted per backend by the budget allocator",
    ("backend", "allocator"))
_M_RUNGS = _REG.counter(
    "cim_search_rungs_total",
    "Portfolio race rungs / bandit waves executed", ("allocator",))
_M_SCHED_RELEASED = _REG.counter(
    "cim_sched_budget_released_pulls_total",
    "Race pulls released into the shared pool by flatlined jobs")
_M_SCHED_ABSORBED = _REG.counter(
    "cim_sched_budget_absorbed_pulls_total",
    "Shared-pool race pulls absorbed by still-improving jobs")
_M_SCHED_FLATLINED = _REG.counter(
    "cim_sched_flatlined_jobs_total",
    "Jobs whose bandit improvement rate flatlined mid-race")
for _m in (_M_SCHED_RELEASED, _M_SCHED_ABSORBED, _M_SCHED_FLATLINED):
    _m.inc(0)              # eager child: families render even when idle


# --------------------------------------------------------------------- #
# job description + result
# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class ExploreJob:
    """One (macro, workload, objective, strategy set, area budget) job."""

    macro: MacroSpec
    workload: Workload
    area_budget_mm2: float
    objective: str = "ee"
    strategy_set: str = "st"
    bw: int = 256
    tech: TechConstants = DEFAULT_TECH
    space: DesignSpace | None = None
    merge_ops: bool = True
    #: search backend used when ``run(method=None)`` -- a registered
    #: ``repro_torch.search`` backend name, or "exhaustive"
    search_method: str = "sa"
    #: optional per-job backend settings (the backend's settings
    #: dataclass); ``None`` means the backend's defaults.  Used when
    #: ``run(settings=None)`` and the type matches the method's settings
    #: class; folds into :func:`job_key` like an explicit ``settings=``.
    search_settings: typing.Any = None

    def merged_workload(self) -> Workload:
        """The operator list actually evaluated (merged unless opted out)."""
        return self.workload.merged() if self.merge_ops else self.workload

    def design_space(self) -> DesignSpace:
        """This job's axis space (the default space when none was given)."""
        return self.space or DesignSpace()


@dataclasses.dataclass
class ExploreResult:
    """One job's answer: the winning config, metrics, and search record."""

    config: AcceleratorConfig
    macro: MacroSpec
    workload: str
    objective: str
    strategy_set: str
    per_op_strategy: dict[str, str]
    metrics: dict
    search: dict                      # method, runtime, space stats, device
    #: per-member diagnostics of the stochastic backend run
    sa: SearchResult | None = None

    def summary(self) -> str:
        """One-line human-readable row."""
        c = self.config
        return (
            f"[{self.workload} | {self.macro.name} | {self.objective}/"
            f"{self.strategy_set}] (MR,MC,SCR,IS,OS)="
            f"({c.mr},{c.mc},{c.scr},{c.is_kb},{c.os_kb}) "
            f"EE={self.metrics['tops_w']:.2f} TOPS/W "
            f"Th={self.metrics['gops']:.1f} GOPS "
            f"area={self.metrics['area_mm2']:.2f} mm^2"
        )


# --------------------------------------------------------------------- #
# canonical job identity (in-run dedup)
# --------------------------------------------------------------------- #
#: bump when the cost model / result schema changes meaning.  Schema 2: a
#: ``calibration`` slot joined the payload -- the active calibration
#: version when the settings request measured fidelity, ``None``
#: otherwise -- so an analytic result never answers a calibrated query.
JOB_KEY_SCHEMA = 2
#: keeps a port result from ever sharing a key with a reference result
PORT_TAG = "repro_torch"


def valid_methods() -> tuple[str, ...]:
    """Every accepted ``method=`` name: the registered search backends
    plus the pruned-space ``"exhaustive"`` sweep."""
    return available_backends() + ("exhaustive",)


def _check_method(method: str) -> None:
    if method != "exhaustive":
        get_backend(method)              # raises ValueError with the list


def preferred_settings(job: "ExploreJob | None", method: str,
                       settings=None):
    """The settings-precedence rule: explicit ``settings`` wins, then a
    type-matching ``job.search_settings``, else ``None`` (the caller
    applies its own defaults)."""
    if method == "exhaustive":
        return None
    if settings is not None:
        return settings
    s = job.search_settings if job is not None else None
    if s is not None and isinstance(s, get_backend(method).settings_cls):
        return s
    return None


def _canonical(obj):
    """JSON-able canonical form of job ingredients (dataclasses, tuples,
    floats-as-hex so equality is bit-exact, not repr-approximate)."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        out = {"__type__": type(obj).__name__}
        for f in dataclasses.fields(obj):
            out[f.name] = _canonical(getattr(obj, f.name))
        return out
    if isinstance(obj, (tuple, list)):
        return [_canonical(x) for x in obj]
    if isinstance(obj, dict):
        return {str(k): _canonical(v) for k, v in sorted(obj.items())}
    if isinstance(obj, (bool, np.bool_)):
        return bool(obj)
    if isinstance(obj, (int, np.integer)):
        return int(obj)
    if isinstance(obj, (float, np.floating)):
        return float(obj).hex()
    if isinstance(obj, str) or obj is None:
        return obj
    return repr(obj)                               # pragma: no cover


def job_key(
    job: ExploreJob,
    method: str | None = None,
    settings=None,
    dtype: torch.dtype = torch.float32,
) -> str:
    """Content hash identifying one exploration's *answer*.

    Two submissions share a key iff they are guaranteed the same result:
    same job ingredients, same search method (``None`` defers to
    ``job.search_method``), same backend settings (``None`` defers to a
    type-matching ``job.search_settings``), the same working dtype, and,
    for measured-fidelity settings, the same active calibration version
    (read without running a kernel sweep).  The payload carries the
    port's tag, so a port key never equals a reference key.
    """
    method = method or job.search_method
    settings = preferred_settings(job, method, settings)
    calibration = None
    if getattr(settings, "fidelity", "analytic") == "measured":
        from repro_torch.core.calibration import active_calibration_version
        calibration = active_calibration_version()
    payload = {
        "schema": JOB_KEY_SCHEMA,
        "port": PORT_TAG,
        "calibration": calibration,
        "dtype": str(dtype),
        "job": _canonical(dataclasses.replace(
            job, space=job.design_space(), search_method=method,
            search_settings=None)),
        "method": method,
        "settings": _canonical(settings) if method != "exhaustive" else None,
    }
    blob = json.dumps(payload, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; asking for ``cuda`` on a host with
    no card raises instead of carrying on on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but no CUDA card is present; "
            "pass device='cpu' to run the plain PyTorch version")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def device_name(dev: torch.device) -> str:
    """The name a result records for the device it ran on."""
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


class _PreparedJob(typing.NamedTuple):
    job: ExploreJob
    workload: Workload               # merged view actually evaluated
    ops_pad: int                     # operator bucket width
    mat: np.ndarray                  # [5, L] axis-value matrix (unpadded L)
    lens: np.ndarray                 # [5]


def _pow2_at_least(n: int, floor: int = 4) -> int:
    return max(floor, 1 << (int(n) - 1).bit_length())


def _job_arrays(p: _PreparedJob) -> cost_model.JobParams:
    """Numpy-leaved JobParams for one prepared job (stacked by the caller)."""
    j = p.job
    return cost_model.job_params_np(
        p.workload.as_arrays(pad_to=p.ops_pad), j.macro, j.tech, j.objective,
        j.strategy_set, j.area_budget_mm2, j.bw)


def _spearman(a: np.ndarray, b: np.ndarray) -> float:
    """Spearman rank correlation between two value vectors (1.0 for
    degenerate inputs: fewer than two points, or zero rank variance).
    The two-fidelity report uses it to quantify how well the analytic
    ranking predicted the measured one."""
    a = np.asarray(a, dtype=float)
    b = np.asarray(b, dtype=float)
    if len(a) < 2:
        return 1.0
    ra = np.argsort(np.argsort(a, kind="stable"),
                    kind="stable").astype(float)
    rb = np.argsort(np.argsort(b, kind="stable"),
                    kind="stable").astype(float)
    da, db = ra - ra.mean(), rb - rb.mean()
    denom = float(np.sqrt((da ** 2).sum() * (db ** 2).sum()))
    if denom == 0.0:                                   # pragma: no cover
        return 1.0
    return float((da * db).sum() / denom)


def clone_result(r: ExploreResult) -> ExploreResult:
    """Fan-out copy for deduped submissions (fresh mutable containers so
    callers mutating one result cannot alias another).  ``search`` is
    deep-copied: portfolio results nest mutable dicts inside it."""
    return dataclasses.replace(
        r, per_op_strategy=dict(r.per_op_strategy),
        metrics=dict(r.metrics), search=copy.deepcopy(r.search))


# --------------------------------------------------------------------- #
# the engine
# --------------------------------------------------------------------- #
class ExplorationEngine:
    """Runs lists of :class:`ExploreJob` through the batched objective."""

    #: candidate block width of one exhaustive evaluation call
    EXHAUSTIVE_CHUNK = 4096

    def __init__(
        self,
        sa_settings: SASettings = SASettings(),
        penalty_scale: float = 1e3,
        *,
        device="cuda",
        dtype: torch.dtype = torch.float32,
        evaluator=None,
        device_race: bool = True,
    ):
        """Build an engine on ``device`` working in ``dtype``.

        ``sa_settings`` are the defaults the ``"sa"`` method runs with.
        ``evaluator`` is the batched objective, with the signature of
        ``kernels.ops.job_objective`` (the default); passing the kernel's
        plain version (``kernels.ref.job_objective_ref``) runs the same
        engine without the kernel, to hold one against the other.
        ``device_race=False`` keeps portfolio races on ``device`` even when
        :func:`repro_torch.core.distributed.race_devices` lists several
        devices of its kind.
        """
        if dtype not in (torch.float32, torch.float64):
            raise TypeError(f"dtype must be float32 or float64, got {dtype}")
        self.device = resolve_device(device)
        self.dtype = dtype
        self.sa_settings = sa_settings
        self.penalty_scale = float(penalty_scale)
        self.evaluator = evaluator or ops.job_objective
        self._device_race = bool(device_race)
        # per-instance counters mirrored into the process-wide registry
        # (the /v1/metrics families above); the service's worker thread
        # and callers on other threads may bump them concurrently
        self.stats = obs.StatCounters({
            "jobs": _M_JOBS.labels(),
            "batches": _M_BATCHES.labels(),
            "dedup_hits": _M_DEDUP.labels(),
            "device_race_dispatches": _M_RACE.labels(),
        })

    def stats_snapshot(self) -> dict:
        """JSON-able counter view for service introspection
        (``/v1/stats``): the run counters and the device and dtype the
        engine works in (the port has no executable cache to report)."""
        return {**self.stats.snapshot(),
                "device": device_name(self.device),
                "dtype": str(self.dtype)}

    # ------------------------------------------------------------- #
    # public API
    # ------------------------------------------------------------- #
    def default_settings(self, method: str):
        """Effective settings when the caller supplies none: the engine's
        ``sa_settings`` for SA, the backend's defaults otherwise, ``None``
        for exhaustive."""
        if method == "exhaustive":
            return None
        if method == "sa":
            return self.sa_settings
        return get_backend(method).default_settings()

    def _resolve_settings(self, method: str, settings):
        if method == "exhaustive":
            return None                # sweep has no knobs; ignore settings
        if settings is None:
            return self.default_settings(method)
        backend = get_backend(method)
        if not isinstance(settings, backend.settings_cls):
            raise TypeError(
                f"method {method!r} expects {backend.settings_cls.__name__}"
                f" settings, got {type(settings).__name__}")
        return settings

    def _effective_settings(self, job: ExploreJob, method: str, settings):
        if settings is not None:
            return self._resolve_settings(method, settings)  # type-check
        s = preferred_settings(job, method)
        return s if s is not None else self.default_settings(method)

    def run(
        self,
        jobs: typing.Sequence[ExploreJob],
        method: str | None = None,
        settings=None,
        sa_settings: SASettings | None = None,
        keys: typing.Sequence[str] | None = None,
        admit: typing.Callable[[], list] | None = None,
    ) -> list[ExploreResult]:
        """Co-explore every job; results come back in submission order.

        ``method`` is a registered search backend name (``"sa"``,
        ``"genetic"``, ``"evolution"``, ``"sobol"``, ``"portfolio"``) or
        ``"exhaustive"``; ``None`` uses each job's own ``search_method``.
        ``settings`` must match the backend's settings class, requires a
        homogeneous method across the batch, and overrides every job's own
        ``search_settings``; ``sa_settings`` is the SA spelling.  ``keys``
        lets callers that already computed :func:`job_key` for each job
        skip re-hashing; when given it must align 1:1 with ``jobs``.

        ``admit`` is the continuous-batching admission hook: a callable
        polled once per bandit wave that returns late-arriving ``(job,
        key)`` pairs to join the in-flight race at the next rung boundary.
        It requires a single-bucket batch running a bandit-allocator
        portfolio; admitted jobs start their own pull schedule from zero,
        so each one's result equals a solo submission bit for bit.  Their
        results are appended AFTER the initial jobs' results, in
        admission order.
        """
        t_start = time.perf_counter()
        if settings is None:
            settings = sa_settings
        methods = [method or j.search_method for j in jobs]
        for m in set(methods):
            _check_method(m)
        if settings is not None and len(set(methods)) > 1:
            raise ValueError(
                "explicit settings require a single method across the "
                f"batch, got {sorted(set(methods))}")
        eff = [self._effective_settings(j, m, settings)
               for j, m in zip(jobs, methods)]

        # identical submissions (same canonical key) evaluate ONCE; the
        # result fans out to every duplicate slot below
        if keys is None:
            keys = [job_key(j, m, s, self.dtype)
                    for j, m, s in zip(jobs, methods, eff)]
        elif len(keys) != len(jobs):
            raise ValueError(
                f"keys length {len(keys)} != jobs length {len(jobs)}")
        first_of: dict[str, int] = {}
        unique: list[int] = []
        for i, k in enumerate(keys):
            if k in first_of:
                self.stats.bump("dedup_hits")
            else:
                first_of[k] = i
                unique.append(i)

        prepared = {i: self._prepare(jobs[i]) for i in unique}
        self.stats.bump("jobs", len(jobs))

        results: list[ExploreResult | None] = [None] * len(jobs)
        admitted_results: list[ExploreResult] = []
        groups: dict = {}
        for i in unique:
            key = (self._bucket_key(prepared[i], methods[i]), eff[i])
            groups.setdefault(key, []).append(i)
        if admit is not None:
            self._check_admittable(groups)
        with obs.span("engine.run", histogram=_M_RUN_S,
                      jobs=len(jobs), unique=len(unique)):
            for (bucket, group_settings), idxs in groups.items():
                m = bucket[0]
                batch = [prepared[i] for i in idxs]
                self.stats.bump("batches")
                _LOG.debug("batch method=%s jobs=%d bucket=%s",
                           m, len(idxs), bucket)
                if m == "exhaustive":
                    outs = self._run_exhaustive_batch(batch)
                elif get_backend(m).composite:
                    outs = self._run_portfolio_batch(
                        batch, group_settings,
                        job_keys=[keys[i] for i in idxs],
                        admit=None if admit is None else
                        self._wrap_admit(admit, bucket, m))
                    # rung-admitted jobs ride behind the initial batch
                    admitted_results = list(outs[len(idxs):])
                    outs = outs[:len(idxs)]
                else:
                    outs = self._run_search_batch(batch, get_backend(m),
                                                  group_settings)
                for i, out in zip(idxs, outs):
                    results[i] = out
        fanout: dict[str, int] = {}
        for i, k in enumerate(keys):
            if results[i] is None:
                results[i] = clone_result(results[first_of[k]])
                fanout[k] = fanout.get(k, 0) + 1
        # dedup provenance: a timeline whose result fanned out to
        # duplicate slots says so (annotate no-ops for keys without one)
        recorder = obs.flight_recorder()
        for k, n in fanout.items():
            recorder.annotate(k, dedup_fanout=n)

        results.extend(admitted_results)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        runtime = time.perf_counter() - t_start
        for r in results:
            r.search["runtime_s"] = runtime
            r.search["batch_jobs"] = len(results)
        return typing.cast("list[ExploreResult]", results)

    def candidate_values(
        self,
        jobs: typing.Sequence[ExploreJob],
        candidates: typing.Sequence[np.ndarray],
    ) -> list[np.ndarray]:
        """Objective values of explicit candidate lists, one ``[C_j]`` float
        array per job (batched across jobs; used by the Pareto frontier)."""
        prepared = [self._prepare(j) for j in jobs]
        out: list[np.ndarray | None] = [None] * len(prepared)
        groups: dict = {}
        for i, p in enumerate(prepared):
            groups.setdefault(p.ops_pad, []).append(i)
        for idxs in groups.values():
            vals = self._sweep_values(
                self._stack([prepared[i] for i in idxs]),
                [np.asarray(candidates[i], np.float64) for i in idxs])
            for i, v in zip(idxs, vals):
                out[i] = v
        return typing.cast("list[np.ndarray]", out)

    # ------------------------------------------------------------- #
    # internals
    # ------------------------------------------------------------- #
    def _prepare(self, job: ExploreJob) -> _PreparedJob:
        wl = job.merged_workload()
        mat, lens = _axes_matrix(job.design_space())
        return _PreparedJob(
            job=job, workload=wl,
            ops_pad=_pow2_at_least(len(wl.ops)),
            mat=mat, lens=lens,
        )

    def bucket_key(self, job: ExploreJob, method: str | None = None) -> tuple:
        """Batch signature of a job: jobs sharing a bucket (and their
        effective settings) run in one batched evaluator loop, so the
        service queue groups submissions by this and dispatches each
        group as exactly one ``run()``."""
        return self._bucket_key(self._prepare(job),
                                method or job.search_method)

    @staticmethod
    def _bucket_key(p: _PreparedJob, method: str) -> tuple:
        return (method, p.ops_pad)

    def _stack(self, batch: list[_PreparedJob],
               device=None) -> cost_model.JobParams:
        return cost_model.stack_job_params(
            [_job_arrays(p) for p in batch], self.dtype,
            device or self.device)

    def _tensor(self, a: np.ndarray, device=None) -> torch.Tensor:
        return torch.as_tensor(a, dtype=self.dtype).to(device or self.device)

    # ---- continuous-batching admission ---------------------------- #
    @staticmethod
    def _check_admittable(groups: dict) -> None:
        """Reject ``admit=`` for batches that have no rung boundaries to
        admit at: admission needs exactly one bucket, running the
        composite portfolio under the bandit allocator (halving culls
        across rungs and plain backends are single-shot, so a late join
        would perturb the in-flight jobs)."""
        if len(groups) != 1:
            raise ValueError(
                "rung admission requires a single executable bucket per "
                f"run() call, got {len(groups)} groups")
        ((bucket, group_settings),) = groups.keys()
        m = bucket[0]
        if m == "exhaustive" or not get_backend(m).composite or \
                getattr(group_settings, "allocator", None) != "bandit":
            raise ValueError(
                "rung admission requires a bandit-allocator portfolio "
                f"group, got method={m!r} allocator="
                f"{getattr(group_settings, 'allocator', None)!r}")

    def _wrap_admit(self, admit, bucket: tuple, method: str):
        """Engine-side admission shim: prepares each late ``(job, key)``
        pair the caller's hook returns and verifies it belongs to the
        in-flight bucket (a mismatch would corrupt the batched launch
        shapes)."""
        def engine_admit() -> list:
            out = []
            for job, key in admit():
                p = self._prepare(job)
                got = self._bucket_key(p, method)
                if got != bucket:
                    raise ValueError(
                        f"admitted job bucket {got} does not match the "
                        f"in-flight group bucket {bucket}")
                self.stats.bump("jobs")
                out.append((key, p))
            return out
        return engine_admit

    # ---- search-backend path -------------------------------------- #
    def _dispatch_backend_async(
        self, batch: list[_PreparedJob], backend, settings,
        device=None, seed_rows: typing.Sequence[int] | None = None,
    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """One batched backend run over a bucket; returns the device
        tensors ``(best_idx [J, members, 5], best_val [J, members],
        trace [J, steps])`` without waiting for them, so the portfolio
        can launch several backends -- possibly on several devices --
        before it reads any.  ``device`` places every operand and the
        generators there (``None`` = the engine's device).  Each job
        draws from its own generator, seeded ``settings.seed`` or, with
        ``seed_rows``, its own seed (the bandit's per-job pull seeds)."""
        dev = self.device if device is None else device
        stacked = self._stack(batch, dev)
        width = max(p.mat.shape[1] for p in batch)
        mats = np.stack([
            np.concatenate(
                [p.mat, np.repeat(p.mat[:, -1:], width - p.mat.shape[1],
                                  axis=1)], axis=1)
            for p in batch])                                 # [J, 5, L]
        lens = torch.as_tensor(np.stack([p.lens for p in batch]),
                               dtype=torch.long, device=dev)
        if device is not None:
            self.stats.bump("device_race_dispatches")

        def objective(cfg):
            return self.evaluator(stacked, cfg.contiguous(),
                                  self.penalty_scale)

        return backend.run(
            objective, self._tensor(mats, dev), lens, stacked.bw, settings,
            backend.make_generators(settings, dev, len(batch),
                                    seeds=seed_rows))

    def _search_winner(
        self, p: _PreparedJob, method: str,
        best_idx: np.ndarray,          # [members, 5] of this job
        best_val: np.ndarray,          # [members]
        trace: np.ndarray,             # [steps]
    ) -> tuple[AcceleratorConfig, dict, SearchResult]:
        """Shared epilogue of every stochastic backend: pick the winning
        member, snap-verify the area budget, attach diagnostics."""
        job = p.job
        winner = int(np.argmin(best_val))
        vals = p.mat[np.arange(5), best_idx[winner]]
        diag = SearchResult(
            best_cfg=torch.as_tensor(
                np.concatenate([vals, [float(job.bw)]])),
            best_value=torch.as_tensor(best_val[winner]),
            best_per_chain=torch.as_tensor(best_val),
            trace_best=torch.as_tensor(trace),
        )
        cfg = AcceleratorConfig(*[int(round(v)) for v in vals], bw=job.bw)
        search: dict = {"method": method,
                        "merged_ops": len(p.workload.ops),
                        "raw_ops": len(job.workload.ops)}
        # backends walk the raw grid with an area penalty; snap-verify
        # feasibility and fall back to the pruned-space optimum if the
        # penalty let the winner out of budget (rare)
        if accelerator_area_mm2(cfg, job.macro, job.tech) > \
                job.area_budget_mm2 * 1.001:
            cfg, stats = self._exhaustive_one(p)
            search.update(stats)
        return cfg, search, diag

    def _run_search_batch(
        self, batch: list[_PreparedJob], backend, settings,
    ) -> list[ExploreResult]:
        """One batched backend run over a bucket, then each job's winner
        snapped to a config and finished."""
        best_idx, best_val, trace = (
            x.cpu().numpy()
            for x in self._dispatch_backend_async(batch, backend,
                                                  settings))
        won = [self._search_winner(p, backend.name, best_idx[jx],
                                   best_val[jx], trace[jx])
               for jx, p in enumerate(batch)]
        return self._finish_batch(batch, *map(list, zip(*won)))

    # ---- portfolio (bandit / successive-halving racer) ------------ #
    def _race_devices(self) -> list:
        """Devices portfolio race waves round-robin across: those of
        :func:`repro_torch.core.distributed.race_devices` of the engine's
        device kind.  ``[None]`` (the engine's device, no placement) when
        fewer than two remain or ``device_race=False`` -- the one-device
        path is the same code with no placement step."""
        if not self._device_race:
            return [None]
        from repro_torch.core.distributed import race_devices

        devs = [d for d in race_devices() if d.type == self.device.type]
        return devs if len(devs) > 1 else [None]

    def _run_portfolio_batch(
        self, batch: list[_PreparedJob], settings,
        job_keys: typing.Sequence[str] | None = None,
        admit: typing.Callable[[], list] | None = None,
    ) -> list[ExploreResult]:
        """Race the constituent backends per job under the settings'
        budget allocator, then spend the remaining budget on each job's
        winner.  The reported best is the min across every phase.
        ``job_keys`` (aligned 1:1 with ``batch``) enables per-rung events
        on :func:`repro_torch.obs.progress_bus` and the flight recorder --
        one event per job per race wave plus a ``phase="final"`` event.

        ``allocator="bandit"``: after one initialization pull per backend
        (identical to halving's rung 0), each adaptive pull goes to the
        per-job UCB argmax over observed improvement rates -- rewards come
        from the best-so-far traces the runs already return, so the
        schedule is deterministic given the seed.
        ``allocator="halving"``: fixed rungs, per-job culling to the best
        ``ceil(k/2)`` each rung.

        The bandit race runs as a wave scheduler: every bandit state (pull
        counters, rewards, UCB choice, derived seeds) is per job, and each
        job draws from generators seeded only by its own pull seeds, so:

        * ``admit`` -- prepared late jobs returned by the hook join the
          next wave at pull 0 and race to completion inside this call,
          each equal to its solo run;
        * cross-job budget flow -- with ``settings.flatline_waves > 0``,
          a job whose last ``flatline_waves`` adaptive pulls each earned
          reward below ``flatline_eps`` releases its remaining race pulls
          into a shared pool that still-improving jobs drain one pull per
          wave; per-job accounting lands in ``search["budget_flow"]``.

        A wave launches every constituent's run before the host waits for
        any, each on its race device (:meth:`_race_devices`, placed by
        ``settings.device_affinity`` or round-robin); the fold of each run
        into the per-job incumbents (one copy to the host per backend per
        wave) is the per-rung best exchange.  Placement never feeds the
        generators, so any placement gives bit-identical results.  With ``fidelity="measured"`` a last rung
        re-scores each job's top-K analytic candidates under
        ``resolve_corrections()`` and reports both rankings.
        """
        from repro_torch.search.portfolio import (
            bandit_pull_plan,
            bandit_rounds,
            constituent_devices,
            derived_seed,
            final_plan,
            pull_reward,
            race_plan,
            ucb_scores,
        )

        batch = list(batch)
        job_keys = None if job_keys is None else list(job_keys)
        if admit is not None and job_keys is None:
            raise ValueError("rung admission requires job_keys")
        names = settings.backends
        n_jobs, n_back = len(batch), len(names)
        devices = self._race_devices()
        n_devices = sum(d is not None for d in devices) or 1
        dev_of = constituent_devices(settings, devices)
        measured = getattr(settings, "fidelity", "analytic") == "measured"
        bus = obs.progress_bus()
        recorder = obs.flight_recorder()
        # the flight recorder opens one decision timeline per job,
        # capturing the same per-rung payloads the bus publishes (so the
        # two reconcile exactly) plus bandit internals
        device_map = {name: str(dev_of[b_idx] or "default")
                      for b_idx, name in enumerate(names)}
        if job_keys is not None:
            for j in range(n_jobs):
                recorder.start(
                    job_keys[j], method="portfolio",
                    allocator=settings.allocator, backends=list(names),
                    devices=n_devices, device_map=device_map,
                    total_evals=settings.total_evals,
                    rungs=settings.rungs, seed=settings.seed)
        best_val = np.full(n_jobs, np.inf)
        best_idx = np.zeros((n_jobs, 5), dtype=np.int64)
        per_backend = np.full((n_jobs, n_back), np.inf)
        # diagnostics track the run that PRODUCED each job's current best,
        # so min(best_per_chain) == min(trace_best) == the reported value
        member_vals: list[np.ndarray | None] = [None] * n_jobs
        traces: list[np.ndarray | None] = [None] * n_jobs
        # per-job candidate pool across every phase (axis-index tuple ->
        # best analytic value seen); the measured rung re-scores its
        # top-K, so only a measured race fills it
        pool: list[dict[tuple, float]] = [dict() for _ in range(n_jobs)]

        def _launch(b_idx: int, scaled, sel: list[int], seed_rows=None):
            """Launch one backend's run over ``sel`` on its race device
            (the host does not wait); returns a handle for
            :func:`_collect`."""
            if not sel:
                return None
            arrays = self._dispatch_backend_async(
                [batch[j] for j in sel], get_backend(names[b_idx]), scaled,
                device=dev_of[b_idx], seed_rows=seed_rows)
            return (b_idx, sel, arrays)

        def _collect(handle, prev=None,
                     fold_race=True) -> dict[int, tuple[float, float]]:
            """Copy one launched run to the host and fold it into the
            per-job incumbents (the best exchange); returns ``{job: (run
            best, pull reward vs the pre-wave incumbents ``prev``)}``.
            Only the bandit race passes ``prev``."""
            b_idx, sel, arrays = handle
            idx_a, val_a, tr_a = (x.cpu().numpy() for x in arrays)
            out: dict[int, tuple[float, float]] = {}
            for pos, j in enumerate(sel):
                w = int(np.argmin(val_a[pos]))
                v = float(val_a[pos, w])
                out[j] = (v, pull_reward(prev[j], tr_a[pos])
                          if prev is not None else 0.0)
                if fold_race:
                    per_backend[j, b_idx] = min(per_backend[j, b_idx], v)
                if v < best_val[j]:
                    best_val[j] = v
                    best_idx[j] = idx_a[pos, w]
                    member_vals[j] = val_a[pos]
                    traces[j] = tr_a[pos]
                if measured:
                    pj = pool[j]
                    for m in np.flatnonzero(np.isfinite(val_a[pos])):
                        vm = float(val_a[pos, m])
                        t = tuple(int(x) for x in idx_a[pos, m])
                        if vm < pj.get(t, np.inf):
                            pj[t] = vm
            return out

        pulls = np.zeros((n_jobs, n_back), dtype=np.int64)

        def _record_pull(j: int, b_idx: int) -> None:
            pulls[j, b_idx] += 1
            _M_PULLS.inc(backend=names[b_idx], allocator=settings.allocator)

        def _fin(v: float) -> float | None:
            return float(v) if np.isfinite(v) else None

        def _publish(phase: str, rung: int,
                     jobs_touched: typing.Iterable[int],
                     rewards: dict | None = None,
                     ucb=None, chosen: dict | None = None) -> None:
            """One progress event per touched job after a race wave (no-op
            without ``job_keys``).  The identical payload lands on the
            flight recorder, extended with the wave's bandit internals
            (``rewards`` per job, UCB ``scores`` and the ``chosen`` arm)
            for the jobs that made an ADAPTIVE pull this wave."""
            if job_keys is None:
                return
            for j in jobs_touched:
                payload = dict(
                    phase=phase, allocator=settings.allocator,
                    rung=rung, best=_fin(best_val[j]),
                    backend_best={name: _fin(per_backend[j, b])
                                  for b, name in enumerate(names)},
                    pulls={name: int(pulls[j, b])
                           for b, name in enumerate(names)},
                    devices=n_devices)
                bus.publish(job_keys[j], **payload)
                if rewards is not None and j in rewards:
                    payload["rewards"] = rewards[j]
                if chosen is not None and j in chosen:
                    if ucb is not None:
                        payload["ucb"] = {name: _fin(ucb[j, b])
                                          for b, name in enumerate(names)}
                    payload["chosen"] = names[int(chosen[j])]
                recorder.event(job_keys[j], payload)

        # cross-job budget-flow accounting (bandit allocator only; the
        # halving branch leaves the defaults, so ``search["budget_flow"]``
        # reads uniformly for every portfolio result)
        flatlined = [False] * n_jobs
        released = [0] * n_jobs
        absorbed = [0] * n_jobs
        admit_wave = [0] * n_jobs
        spare_pulls = 0

        if settings.allocator == "halving":
            alive = np.ones((n_jobs, n_back), dtype=bool)
            for rung_no, rung in enumerate(race_plan(settings)):
                _M_RUNGS.inc(allocator="halving")
                with obs.span("engine.portfolio.rung", allocator="halving",
                              rung=rung_no, jobs=n_jobs):
                    handles = [
                        _launch(b_idx, rung[name],
                                [j for j in range(n_jobs)
                                 if alive[j, b_idx]])
                        for b_idx, name in enumerate(names)]
                    for h in handles:
                        if h is not None:
                            for j in _collect(h):
                                _record_pull(j, h[0])
                _publish("race", rung_no, range(n_jobs))
                # cull: each job keeps its best ceil(k/2) survivors
                for j in range(n_jobs):
                    live = np.flatnonzero(alive[j])
                    keep = -(-len(live) // 2)
                    order = live[np.argsort(per_backend[j, live],
                                            kind="stable")]
                    alive[j, order[keep:]] = False
        else:                                          # "bandit"
            # every job carries its OWN pull schedule (counters, rewards,
            # derived seeds): the seed of pull p is derived_seed(seed,
            # backend, p), batch-independent, so a late-admitted job
            # starting at pull 0 follows exactly its solo trajectory
            sum_reward = np.zeros((n_jobs, n_back))
            base_rounds = bandit_rounds(settings)
            flow_on = settings.flatline_waves > 0
            needs_init = [True] * n_jobs
            race_budget = [base_rounds] * n_jobs
            flat_run = [0] * n_jobs   # consecutive flat adaptive pulls
            wave = 0

            def _admit_pending() -> None:
                """Poll the caller's admission hook and extend every
                per-job state row for the newcomers (they join the next
                wave's initialization pulls)."""
                nonlocal n_jobs, best_val, best_idx, per_backend, \
                    pulls, sum_reward
                for key, p in admit():
                    batch.append(p)
                    job_keys.append(key)
                    best_val = np.append(best_val, np.inf)
                    best_idx = np.concatenate(
                        [best_idx, np.zeros((1, 5), dtype=np.int64)])
                    per_backend = np.concatenate(
                        [per_backend, np.full((1, n_back), np.inf)])
                    pulls = np.concatenate(
                        [pulls, np.zeros((1, n_back), dtype=np.int64)])
                    sum_reward = np.concatenate(
                        [sum_reward, np.zeros((1, n_back))])
                    member_vals.append(None)
                    traces.append(None)
                    pool.append(dict())
                    needs_init.append(True)
                    race_budget.append(base_rounds)
                    flat_run.append(0)
                    flatlined.append(False)
                    released.append(0)
                    absorbed.append(0)
                    admit_wave.append(wave)
                    n_jobs += 1
                    recorder.start(
                        key, method="portfolio",
                        allocator=settings.allocator,
                        backends=list(names), devices=n_devices,
                        device_map=device_map,
                        total_evals=settings.total_evals,
                        rungs=settings.rungs, seed=settings.seed,
                        admitted_wave=wave)

            while True:
                if admit is not None:
                    _admit_pending()
                # plan the wave: newcomers initialize (one pull per
                # backend, == halving's rung 0); veterans with budget
                # make their UCB-argmax adaptive pull (first index wins
                # ties); spent-but-hot jobs drain the shared pool one
                # pull per wave
                init_jobs = [j for j in range(n_jobs) if needs_init[j]]
                chosen: dict[int, int] = {}
                scores = None
                spent = pulls.sum(axis=1)
                ready = [j for j in range(n_jobs)
                         if not needs_init[j] and not flatlined[j]]
                if ready:
                    scores = ucb_scores(
                        sum_reward / np.maximum(pulls, 1), pulls,
                        settings.ucb_c)
                    choice = np.argmax(scores, axis=1)
                    for j in ready:
                        if spent[j] < race_budget[j]:
                            chosen[j] = int(choice[j])
                        elif spare_pulls > 0:
                            spare_pulls -= 1
                            absorbed[j] += 1
                            chosen[j] = int(choice[j])
                            _M_SCHED_ABSORBED.inc()
                            if job_keys is not None:
                                fp = dict(
                                    phase="budget_flow", action="absorb",
                                    allocator=settings.allocator,
                                    rung=wave, absorbed=absorbed[j],
                                    pool=spare_pulls)
                                bus.publish(job_keys[j], **fp)
                                recorder.event(job_keys[j], fp)
                if not init_jobs and not chosen:
                    break
                _M_RUNGS.inc(allocator="bandit")
                prev = best_val.copy()
                touched: set[int] = set()
                wave_rewards: dict[int, dict[str, float]] = {}
                with obs.span("engine.portfolio.rung",
                              allocator="bandit", rung=wave,
                              jobs=n_jobs):
                    handles = []
                    for b_idx in range(n_back):
                        sel = sorted(set(init_jobs) |
                                     {j for j, b in chosen.items()
                                      if b == b_idx})
                        if not sel:
                            continue
                        handles.append(_launch(
                            b_idx, bandit_pull_plan(settings, b_idx, 0),
                            sel,
                            seed_rows=[derived_seed(settings.seed, b_idx,
                                                    int(pulls[j, b_idx]))
                                       for j in sel]))
                    for h in handles:
                        for j, (_v, r) in _collect(h, prev).items():
                            sum_reward[j, h[0]] += r
                            _record_pull(j, h[0])
                            touched.add(j)
                            wave_rewards.setdefault(j, {})[
                                names[h[0]]] = float(r)
                            if flow_on and j in chosen:
                                flat_run[j] = 0 \
                                    if r >= settings.flatline_eps \
                                    else flat_run[j] + 1
                for j in init_jobs:
                    needs_init[j] = False
                _publish("race", wave, sorted(touched),
                         rewards=wave_rewards, ucb=scores, chosen=chosen)
                if flow_on:
                    # flatline release: a job whose improvement rate
                    # dried up hands its unspent race pulls to the pool
                    spent = pulls.sum(axis=1)
                    for j in range(n_jobs):
                        if flatlined[j] or needs_init[j] or \
                                flat_run[j] < settings.flatline_waves:
                            continue
                        rem = int(race_budget[j] - spent[j])
                        flatlined[j] = True
                        _M_SCHED_FLATLINED.inc()
                        if rem > 0:
                            released[j] = rem
                            race_budget[j] = int(spent[j])
                            spare_pulls += rem
                            _M_SCHED_RELEASED.inc(rem)
                        if job_keys is not None:
                            fp = dict(
                                phase="budget_flow", action="release",
                                allocator=settings.allocator, rung=wave,
                                released=rem, pool=spare_pulls,
                                spent=int(spent[j]))
                            bus.publish(job_keys[j], **fp)
                            recorder.event(job_keys[j], fp)
                wave += 1

        # exploitation: the per-job winner gets the remaining budget
        # (kept out of per_backend so `race` stays race-phase-only)
        winners = per_backend.argmin(axis=1)
        final = final_plan(settings)
        final_best = np.full(n_jobs, np.inf)
        with obs.span("engine.portfolio.final", allocator=settings.allocator,
                      jobs=n_jobs):
            handles = [
                _launch(b_idx, final[name],
                        [j for j in range(n_jobs) if winners[j] == b_idx])
                for b_idx, name in enumerate(names)]
            for h in handles:
                if h is None:
                    continue
                for j, (v, _r) in _collect(h, fold_race=False).items():
                    final_best[j] = v

        # measured fidelity: re-score each job's top-K analytic
        # candidates under kernel-measurement-calibrated tech constants
        # and report both rankings plus their rank correlation
        two_fidelity: list[dict | None] = [None] * n_jobs
        preps = list(batch)
        win_idx, win_val = best_idx, best_val
        if measured:
            from repro_torch.core.calibration import (
                calibration_version,
                resolve_corrections,
            )

            with obs.span("engine.portfolio.measured",
                          allocator=settings.allocator, jobs=n_jobs):
                cf, source, meas_records = resolve_corrections()
                version = calibration_version(cf)
                topk = int(getattr(settings, "topk", 8))
                preps = [
                    p._replace(job=dataclasses.replace(
                        p.job, tech=p.job.tech.with_corrections(cf)))
                    for p in batch]
                top_rows, cand_rows = [], []
                for j, p in enumerate(batch):
                    # deterministic top-K: analytic value, then axis
                    # indices break ties
                    ranked = sorted(pool[j].items(),
                                    key=lambda kv: (kv[1], kv[0]))[:topk]
                    top_rows.append([t for t, _v in ranked])
                    cand_rows.append(np.stack([
                        np.concatenate(
                            [p.mat[np.arange(5), np.asarray(t)],
                             [float(p.job.bw)]])
                        for t, _v in ranked]))
                vals_a = self._sweep_values(self._stack(batch), cand_rows)
                vals_m = self._sweep_values(self._stack(preps), cand_rows)
                win_idx = np.zeros((n_jobs, 5), dtype=np.int64)
                win_val = np.full(n_jobs, np.inf)
                for j in range(n_jobs):
                    va, vm = vals_a[j], vals_m[j]
                    order_a = np.argsort(va, kind="stable")
                    order_m = np.argsort(vm, kind="stable")
                    w = int(order_m[0])
                    win_idx[j] = top_rows[j][w]
                    win_val[j] = float(vm[w])
                    two_fidelity[j] = {
                        "source": source,
                        "calibration_version": version,
                        "corrections": cf.as_dict(),
                        "topk": len(va),
                        "measurement_count": len(meas_records),
                        "analytic_ranking": [int(x) for x in order_a],
                        "measured_ranking": [int(x) for x in order_m],
                        "analytic_values": [float(x) for x in va],
                        "measured_values": [float(x) for x in vm],
                        "rank_correlation": _spearman(va, vm),
                        "analytic_winner": [
                            int(x)
                            for x in cand_rows[j][int(order_a[0])][:5]],
                        "measured_winner": [
                            int(x) for x in cand_rows[j][w][:5]],
                    }
                    if job_keys is not None:
                        obs.profile.record_measurements(
                            job_keys[j], meas_records)

        if job_keys is not None:
            for j in range(n_jobs):
                payload = dict(
                    phase="final", allocator=settings.allocator,
                    winner=names[int(winners[j])], best=_fin(best_val[j]),
                    final=_fin(final_best[j]),
                    pulls={name: int(pulls[j, b])
                           for b, name in enumerate(names)},
                    devices=n_devices)
                bus.publish(job_keys[j], **payload)
                recorder.event(job_keys[j], payload)
                if two_fidelity[j] is not None:
                    mp = dict(
                        phase="measured", allocator=settings.allocator,
                        best=_fin(win_val[j]),
                        rank_correlation=two_fidelity[j][
                            "rank_correlation"],
                        topk=two_fidelity[j]["topk"],
                        calibration=two_fidelity[j][
                            "calibration_version"],
                        devices=n_devices)
                    bus.publish(job_keys[j], **mp)
                    recorder.event(job_keys[j], mp)
                recorder.finish(
                    job_keys[j], winner=payload["winner"],
                    best=payload["best"], final=payload["final"],
                    pulls=payload["pulls"])

        # a two-fidelity race answers with its measured winner, finished
        # under the calibrated constants
        won = [self._search_winner(preps[j], "portfolio",
                                   win_idx[j][None, :],
                                   np.asarray([win_val[j]]), traces[j])
               for j in range(n_jobs)]
        results = self._finish_batch(preps, *map(list, zip(*won)))
        for j, out in enumerate(results):
            out.search["portfolio"] = {
                "winner": names[int(winners[j])],
                "allocator": settings.allocator,
                "race": {name: float(per_backend[j, b])
                         for b, name in enumerate(names)},
                "pulls": {name: int(pulls[j, b])
                          for b, name in enumerate(names)},
                "final": float(final_best[j]),
                "rungs": settings.rungs,
                "total_evals": settings.total_evals,
                "devices": n_devices,
                "fidelity": getattr(settings, "fidelity", "analytic"),
            }
            out.search["budget_flow"] = {
                "enabled": settings.allocator == "bandit"
                and settings.flatline_waves > 0,
                "flatlined": bool(flatlined[j]),
                "released": int(released[j]),
                "absorbed": int(absorbed[j]),
                "race_pulls": int(pulls[j].sum()),
                "pool_leftover": int(spare_pulls),
                "admitted_wave": int(admit_wave[j]),
            }
            if two_fidelity[j] is not None:
                out.search["two_fidelity"] = two_fidelity[j]
            out.sa = out.sa._replace(
                best_per_chain=torch.as_tensor(member_vals[j]))
        return results

    # ---- exhaustive path ------------------------------------------ #
    def _pruned_candidates(self, p: _PreparedJob) -> tuple[np.ndarray, dict]:
        job = p.job
        cands, stats = prune_space(
            job.design_space(), job.macro, job.area_budget_mm2, job.bw,
            job.tech)
        if len(cands) == 0:
            raise ValueError("no feasible hardware point under budget")
        return candidates_with_bw(cands, job.bw), stats

    def _sweep_values(
        self, stacked: cost_model.JobParams, cand_rows: list[np.ndarray],
    ) -> list[np.ndarray]:
        """Evaluate per-job candidate lists in shared [J, CHUNK] blocks."""
        n_max = max(len(c) for c in cand_rows)
        chunk = min(self.EXHAUSTIVE_CHUNK, n_max)
        outs = []
        for lo in range(0, n_max, chunk):
            # jobs exhaust their lists at different points; pad every lane
            # to the full chunk with its own first row (values discarded)
            lanes = []
            for c in cand_rows:
                part = c[lo: lo + chunk]
                if len(part) < chunk:
                    fill = np.repeat(c[:1], chunk - len(part), axis=0)
                    part = np.concatenate([part, fill], axis=0)
                lanes.append(part)
            block = self._tensor(np.stack(lanes, axis=0))    # [J, chunk, 6]
            outs.append(self.evaluator(stacked, block, self.penalty_scale))
        vals = torch.cat(outs, dim=1).cpu().numpy().astype(np.float64)
        return [vals[jx, :len(c)] for jx, c in enumerate(cand_rows)]

    def _run_exhaustive_batch(
        self, batch: list[_PreparedJob],
    ) -> list[ExploreResult]:
        cands, prune_stats = zip(*[self._pruned_candidates(p) for p in batch])
        vals = self._sweep_values(self._stack(batch), list(cands))
        cfgs, searches = [], []
        for p, c, v, st in zip(batch, cands, vals, prune_stats):
            best = int(np.argmin(v))
            cfgs.append(AcceleratorConfig(
                *[int(x) for x in c[best][:5]], bw=p.job.bw))
            searches.append({"method": "exhaustive",
                             "merged_ops": len(p.workload.ops),
                             "raw_ops": len(p.job.workload.ops), **st})
        return self._finish_batch(batch, cfgs, searches, [None] * len(batch))

    def _exhaustive_one(self, p: _PreparedJob) -> tuple[AcceleratorConfig,
                                                        dict]:
        """Pruned-space optimum of a single job (SA snap-fallback)."""
        rows, stats = self._pruned_candidates(p)
        v = self._sweep_values(self._stack([p]), [rows])[0]
        best = int(np.argmin(v))
        return AcceleratorConfig(
            *[int(x) for x in rows[best][:5]], bw=p.job.bw), stats

    # ---- shared epilogue ------------------------------------------ #
    def _finish_batch(self, batch: list[_PreparedJob],
                      cfgs: list[AcceleratorConfig], searches: list[dict],
                      diags: list) -> list[ExploreResult]:
        """Metrics and per-operator strategies of each job's winner, from
        one evaluator call on the winning rows of the whole bucket."""
        rows = np.array([[c.mr, c.mc, c.scr, c.is_kb, c.os_kb, c.bw]
                         for c in cfgs], dtype=np.float64)
        _, lat, en, idx = self.evaluator(
            self._stack(batch), self._tensor(rows[:, None, :]),
            self.penalty_scale, totals=True)
        lat, en, idx = lat[:, 0].cpu(), en[:, 0].cpu(), idx[:, 0].cpu()
        dev_name = device_name(self.device)
        results = []
        for jx, (p, cfg, search, diag) in enumerate(
                zip(batch, cfgs, searches, diags)):
            job = p.job
            n_ops = len(p.workload.ops)
            metrics = cost_model.metrics_from_totals(
                p.workload.as_arrays(), rows[jx], lat[jx], en[jx],
                idx[jx, :n_ops], job.macro, job.tech)
            per_op = {
                op.name or f"op{i}":
                    str(ALL_STRATEGIES[metrics["strategy_idx"][i]])
                for i, op in enumerate(p.workload.ops)
            }
            search["device"] = dev_name
            search["dtype"] = str(self.dtype)
            results.append(ExploreResult(
                config=cfg,
                macro=job.macro,
                workload=job.workload.name,
                objective=job.objective,
                strategy_set=job.strategy_set,
                per_op_strategy=per_op,
                metrics={k: v for k, v in metrics.items()
                         if k != "strategy_idx"},
                search=search,
                sa=diag,
            ))
        return results


# --------------------------------------------------------------------- #
# process-wide default engines (one per device and dtype)
# --------------------------------------------------------------------- #
_default_engines: dict = {}


def default_engine(device="cuda",
                   dtype: torch.dtype = torch.float32) -> ExplorationEngine:
    """The process-wide engine for ``device`` and ``dtype``, created on
    first use and shared by the ``co_explore`` family."""
    key = (str(resolve_device(device)), dtype)
    if key not in _default_engines:
        _default_engines[key] = ExplorationEngine(device=device, dtype=dtype)
    return _default_engines[key]
