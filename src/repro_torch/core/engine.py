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

The engine runs on ``cuda`` unless the caller asks for ``device="cpu"``; a
``cuda`` engine on a host without a card raises.  ``dtype`` is
``torch.float32`` by default and ``torch.float64`` for exact integer
semantics (the reference's x64 mode).

Identical jobs inside one ``run()`` (same canonical :func:`job_key`)
evaluate once and fan the result out.  ``co_explore`` /
``co_explore_macros`` / ``pareto_explore`` (``core/explorer.py``) call this
engine directly.
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

from repro_torch.core import cost_model
from repro_torch.core.annealing import SASettings, _axes_matrix
from repro_torch.core.calibration import DEFAULT_TECH, TechConstants
from repro_torch.core.ir import Workload
from repro_torch.core.macro import MacroSpec
from repro_torch.core.pruning import DesignSpace, candidates_with_bw, prune_space
from repro_torch.core.strategies import ALL_STRATEGIES
from repro_torch.core.template import AcceleratorConfig, accelerator_area_mm2
from repro_torch.kernels import ops
from repro_torch.search.base import SearchResult, get_backend

__all__ = [
    "ExploreJob",
    "ExploreResult",
    "ExplorationEngine",
    "default_engine",
    "job_key",
    "resolve_device",
]


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
#: bump when the cost model / result schema changes meaning
JOB_KEY_SCHEMA = 1
#: keeps a port result from ever sharing a key with a reference result
PORT_TAG = "repro_torch"


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
    type-matching ``job.search_settings``) and the same working dtype.
    The payload carries the port's tag, so a port key never equals a
    reference key.
    """
    method = method or job.search_method
    settings = preferred_settings(job, method, settings)
    payload = {
        "schema": JOB_KEY_SCHEMA,
        "port": PORT_TAG,
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


def clone_result(r: ExploreResult) -> ExploreResult:
    """Fan-out copy for deduped submissions (fresh mutable containers so
    callers mutating one result cannot alias another)."""
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
    ):
        """Build an engine on ``device`` working in ``dtype``.

        ``sa_settings`` are the defaults the ``"sa"`` method runs with.
        ``evaluator`` is the batched objective, with the signature of
        ``kernels.ops.job_objective`` (the default); passing the kernel's
        plain version (``kernels.ref.job_objective_ref``) runs the same
        engine without the kernel, to hold one against the other.
        """
        if dtype not in (torch.float32, torch.float64):
            raise TypeError(f"dtype must be float32 or float64, got {dtype}")
        self.device = resolve_device(device)
        self.dtype = dtype
        self.sa_settings = sa_settings
        self.penalty_scale = float(penalty_scale)
        self.evaluator = evaluator or ops.job_objective
        self.stats = {"jobs": 0, "batches": 0, "dedup_hits": 0}

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
    ) -> list[ExploreResult]:
        """Co-explore every job; results come back in submission order.

        ``method`` is a registered search backend name (``"sa"``) or
        ``"exhaustive"``; ``None`` uses each job's own ``search_method``.
        ``settings`` must match the backend's settings class, requires a
        homogeneous method across the batch, and overrides every job's own
        ``search_settings``; ``sa_settings`` is the SA spelling.  ``keys``
        lets callers that already computed :func:`job_key` for each job
        skip re-hashing; when given it must align 1:1 with ``jobs``.
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
                self.stats["dedup_hits"] += 1
            else:
                first_of[k] = i
                unique.append(i)

        prepared = {i: self._prepare(jobs[i]) for i in unique}
        self.stats["jobs"] += len(jobs)

        results: list[ExploreResult | None] = [None] * len(jobs)
        groups: dict = {}
        for i in unique:
            key = (self._bucket_key(prepared[i], methods[i]), eff[i])
            groups.setdefault(key, []).append(i)
        for (bucket, group_settings), idxs in groups.items():
            batch = [prepared[i] for i in idxs]
            self.stats["batches"] += 1
            if bucket[0] == "exhaustive":
                outs = self._run_exhaustive_batch(batch)
            else:
                outs = self._run_search_batch(
                    batch, get_backend(bucket[0]), group_settings)
            for i, out in zip(idxs, outs):
                results[i] = out
        for i, k in enumerate(keys):
            if results[i] is None:
                results[i] = clone_result(results[first_of[k]])

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

    @staticmethod
    def _bucket_key(p: _PreparedJob, method: str) -> tuple:
        return (method, p.ops_pad)

    def _stack(self, batch: list[_PreparedJob]) -> cost_model.JobParams:
        return cost_model.stack_job_params(
            [_job_arrays(p) for p in batch], self.dtype, self.device)

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, dtype=self.dtype).to(self.device)

    # ---- search-backend path -------------------------------------- #
    def _run_search_batch(
        self, batch: list[_PreparedJob], backend, settings,
    ) -> list[ExploreResult]:
        """One batched backend run over a bucket, then each job's winner
        snapped to a config and finished."""
        stacked = self._stack(batch)
        width = max(p.mat.shape[1] for p in batch)
        mats = np.stack([
            np.concatenate(
                [p.mat, np.repeat(p.mat[:, -1:], width - p.mat.shape[1],
                                  axis=1)], axis=1)
            for p in batch])                                 # [J, 5, L]
        lens = torch.as_tensor(np.stack([p.lens for p in batch]),
                               dtype=torch.long, device=self.device)

        def objective(cfg):
            return self.evaluator(stacked, cfg.contiguous(),
                                  self.penalty_scale)

        best_idx, best_val, trace = backend.run(
            objective, self._tensor(mats), lens, stacked.bw, settings,
            backend.make_generator(settings, self.device))
        best_idx, best_val, trace = (
            x.cpu().numpy() for x in (best_idx, best_val, trace))

        cfgs, searches, diags = [], [], []
        for jx, p in enumerate(batch):
            job = p.job
            winner = int(np.argmin(best_val[jx]))
            vals = p.mat[np.arange(5), best_idx[jx, winner]]
            diags.append(SearchResult(
                best_cfg=torch.as_tensor(
                    np.concatenate([vals, [float(job.bw)]])),
                best_value=torch.as_tensor(best_val[jx, winner]),
                best_per_chain=torch.as_tensor(best_val[jx]),
                trace_best=torch.as_tensor(trace[jx]),
            ))
            cfg = AcceleratorConfig(*[int(round(v)) for v in vals],
                                    bw=job.bw)
            search: dict = {"method": backend.name,
                            "merged_ops": len(p.workload.ops),
                            "raw_ops": len(job.workload.ops)}
            # backends walk the raw grid with an area penalty; snap-verify
            # feasibility and fall back to the pruned-space optimum if the
            # penalty let the winner out of budget (rare)
            if accelerator_area_mm2(cfg, job.macro, job.tech) > \
                    job.area_budget_mm2 * 1.001:
                cfg, stats = self._exhaustive_one(p)
                search.update(stats)
            cfgs.append(cfg)
            searches.append(search)
        return self._finish_batch(batch, cfgs, searches, diags)

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
        chunk = self.EXHAUSTIVE_CHUNK
        n_max = max(len(c) for c in cand_rows)
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
