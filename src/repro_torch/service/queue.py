"""Thread-backed exploration job queue: continuous batching, dedup.

Submissions accumulate for a small window (or until a batch-size threshold),
dedup by canonical job key, and dispatch as ONE ``ExplorationEngine.run()``
per batch bucket -- so concurrent callers share one batched evaluator loop
(one kernel launch per step for the whole bucket) exactly like a
hand-built batch, while each caller's
:class:`~repro_torch.service.streams.ExploreFuture` resolves the moment
*its* bucket finishes, not when the whole micro-batch drains.

Three admission tiers, checked in order at submit time:

1. **persistent store** (``store.py``) -- repeated queries across processes
   resolve immediately with zero engine work;
2. **in-flight dedup** -- an identical pending/running job fans its result
   out to every duplicate future;
3. **queue** -- new work enters the micro-batch window.

On top of the window, the queue runs a **continuous-batching scheduler**:
while a bandit-allocator portfolio group races, the
engine polls :meth:`JobQueue._admission_hook`'s callback at every rung
boundary, and pending submissions that match the in-flight ``(kind,
method, settings, bucket)`` signature join the running race instead of
waiting out the window behind it.  Admitted entries keep full queue
semantics -- they stay in the in-flight dedup map, their results persist
to the store, and their futures resolve exactly once -- and with no late
arrivals the dispatch is bit-identical to the plain window path
(``QueueConfig(continuous=False)``).

The port's copy of the reference's ``service/queue.py``.  Its queue
serves one engine on one ``torch.device`` in one dtype: a queue without
an engine resolves its device when it is built (``cuda`` unless the
caller asks for ``"cpu"``; a missing card raises there), and job keys
carry the engine's dtype.  The worker thread runs every engine call
inside the engine's CUDA device scope and under :attr:`JobQueue.engine_lock`,
so kernel launches (and the wrappers' launch counters) come from one
thread at a time.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import threading
import time
import typing

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.annealing import SASettings
from repro_torch.core.engine import (
    ExplorationEngine,
    ExploreJob,
    ExploreResult,
    clone_result,
    default_engine,
    job_key,
    preferred_settings,
    resolve_device,
)
from repro_torch.search.base import get_backend
from repro_torch.service.store import ResultStore, default_store
from repro_torch.service.streams import ExploreFuture

__all__ = ["QueueConfig", "JobQueue", "values_key", "resolve_settings"]

# telemetry families (process-wide, the reference's names)
_REG = obs.registry()
_LOG = obs.get_logger("queue")
_M_SUBMITTED = _REG.counter(
    "cim_queue_submitted_total", "Jobs admitted to the service queue")
_M_STORE_HITS = _REG.counter(
    "cim_queue_store_hits_total",
    "Submissions resolved from the persistent result store")
_M_INFLIGHT_DEDUP = _REG.counter(
    "cim_queue_inflight_dedup_total",
    "Submissions folded onto an identical pending/running job")
_M_DISPATCHES = _REG.counter(
    "cim_queue_dispatches_total", "Engine calls issued (one per bucket)")
_M_COMPLETED = _REG.counter(
    "cim_queue_completed_total", "Queue entries resolved successfully")
_M_FAILED = _REG.counter(
    "cim_queue_failed_total", "Queue entries rejected with an error")
_M_WINDOW = _REG.counter(
    "cim_queue_window_flushes_total",
    "Micro-batch windows closed and dispatched")
_M_DEPTH = _REG.gauge(
    "cim_queue_depth", "Instantaneous queue depth", ("state",))
_M_WAIT_S = _REG.histogram(
    "cim_queue_wait_seconds",
    "Submit-to-dispatch latency per queue entry")
# continuous-batching scheduler families; the engine owns the budget-flow
# counters, the queue owns the admission ones
_M_SCHED_ADMISSIONS = _REG.counter(
    "cim_sched_admissions_total",
    "Late submissions admitted into an in-flight group at a rung boundary")
_M_SCHED_CHECKS = _REG.counter(
    "cim_sched_admission_checks_total",
    "Rung-boundary admission polls made by in-flight groups")
_M_SCHED_GROUPS = _REG.gauge(
    "cim_sched_inflight_groups",
    "Executable-bucket groups currently inside an engine call")
_M_SCHED_GROUP_JOBS = _REG.gauge(
    "cim_sched_inflight_group_jobs",
    "Jobs in the currently dispatched group, rung admissions included")
_M_SCHED_GROUPS.set(0)
_M_SCHED_GROUP_JOBS.set(0)


@dataclasses.dataclass(frozen=True)
class QueueConfig:
    #: micro-batch accumulation window after the first pending submission
    batch_window_s: float = 0.02
    #: hard cap on jobs per dispatch (and per admission poll): a bigger
    #: backlog dispatches as successive bounded batches -- or, under the
    #: continuous scheduler, joins the in-flight race in ``max_batch``
    #: slices at successive rung boundaries
    max_batch_jobs: int = 64
    #: continuous batching: let pending submissions that match an
    #: in-flight bandit-portfolio group join its race at the next rung
    #: boundary instead of waiting for the group to finish.  ``False``
    #: restores the pure fixed-window scheduler (every dispatch is a
    #: closed world until it returns)
    continuous: bool = True


class _Entry:
    __slots__ = ("priority", "seq", "kind", "key", "job", "method",
                 "settings", "payload", "futures", "bucket", "t_submit")

    def __init__(self, priority, seq, kind, key, job, method, settings,
                 payload, future):
        self.priority = priority
        self.seq = seq
        self.kind = kind                  # "explore" | "values"
        self.key = key
        self.job = job
        self.method = method
        self.settings = settings
        self.payload = payload            # candidate rows for "values"
        self.futures = [future]
        self.bucket = None                # lazily cached batch bucket
        self.t_submit = time.perf_counter()  # queue-wait histogram anchor

    def order(self) -> tuple:
        return (-self.priority, self.seq)


def values_key(job: ExploreJob, rows: np.ndarray,
               dtype: torch.dtype = torch.float32) -> str:
    """Canonical key of a candidate-sweep submission (job identity in
    ``dtype`` plus the exact candidate rows); shared by the local queue
    and the remote client so both sides address the same in-flight
    future."""
    base = job_key(job, "exhaustive", None, dtype)
    h = hashlib.sha256()
    h.update(base.encode())
    h.update(np.ascontiguousarray(rows, dtype=np.float64).tobytes())
    return "values-" + h.hexdigest()


def resolve_settings(method: str, settings=None, engine=None, job=None):
    """The effective backend settings a submission runs with -- mirrored
    by the remote client so client-side ``job_key`` computation matches
    what the server's queue will use.  Precedence is the shared
    :func:`repro_torch.core.engine.preferred_settings` rule (explicit
    ``settings`` > a type-matching ``job.search_settings``), then the
    backend's defaults.  Raises on unknown backend names."""
    if method == "exhaustive":
        return None
    backend = get_backend(method)        # raises on unknown backends
    settings = preferred_settings(job, method, settings)
    if settings is not None:
        return settings
    if method == "sa":
        return engine.sa_settings if engine is not None else SASettings()
    return backend.default_settings()


#: accepted ``fidelity=`` spellings; "two" is the CLI/benchmark shorthand
#: for a two-fidelity race and normalizes to "measured"
_FIDELITY_ALIASES = {"two": "measured"}
_FIDELITY_VALUES = ("analytic", "measured")


def _normalize_submit_args(job: ExploreJob, method=None, settings=None,
                           sa_settings=None, fidelity=None, engine=None,
                           dtype: torch.dtype = torch.float32):
    """THE shared submit contract: every submit surface (``JobQueue``,
    ``ServiceClient``, ``RemoteQueue``) normalizes its keywords through
    this one helper, so ``(method, settings, priority, fidelity)`` mean
    exactly the same thing everywhere and the canonical ``job_key`` (in
    the serving engine's ``dtype``) can never diverge between local and
    remote spellings.

    Returns ``(method, effective_settings, key)``.  ``sa_settings`` is
    the legacy SA spelling of ``settings``; ``fidelity`` (``"analytic"``,
    ``"measured"``, or the shorthand ``"two"``) overrides the settings'
    own ``fidelity`` field and requires a fidelity-capable backend
    (currently the portfolio racer)."""
    method = method or job.search_method
    if settings is None:
        settings = sa_settings
    settings = resolve_settings(method, settings, engine=engine, job=job)
    if fidelity is not None:
        fid = _FIDELITY_ALIASES.get(fidelity, fidelity)
        if fid not in _FIDELITY_VALUES:
            raise ValueError(
                f"unknown fidelity {fidelity!r}; valid: "
                f"{_FIDELITY_VALUES + tuple(_FIDELITY_ALIASES)}")
        if not hasattr(settings, "fidelity"):
            # every backend is implicitly analytic; only a non-analytic
            # request needs a fidelity-capable backend
            if fid != "analytic":
                raise ValueError(
                    f"method {method!r} does not support fidelity="
                    f"{fidelity!r}; two-fidelity runs need the portfolio "
                    f"backend")
        elif getattr(settings, "fidelity") != fid:
            settings = dataclasses.replace(settings, fidelity=fid)
    return method, settings, job_key(job, method, settings, dtype)


def _tag_job_exc(exc: BaseException, key: str) -> BaseException:
    """Per-future copy of a dispatch failure, carrying the originating
    ``job_key`` both in the message and as a ``.job_key`` attribute (one
    engine error fails a whole bucket; every caller must still be able to
    tell WHICH of its submissions died)."""
    note = f"[job {key[:16]}] "
    if str(exc).startswith(note):
        return exc
    try:
        tagged = type(exc)(f"{note}{exc}")
    except Exception:                    # noqa: BLE001 -- exotic signatures
        tagged = RuntimeError(f"{note}{exc!r}")
    tagged.job_key = key
    tagged.__cause__ = exc
    return tagged


def _device_scope(device):
    """The CUDA device scope of ``device`` (torch's current device is per
    thread), or nothing for the CPU."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


class JobQueue:
    """The always-on exploration service core (one worker thread).

    ``engine=None`` uses the process-wide :func:`default_engine` for
    ``device`` and ``dtype`` (built on first dispatch; the device is
    resolved here, so a ``cuda`` queue on a host without a card raises at
    once); a given engine brings its own device and dtype.
    ``store=None`` disables the persistent result cache; the default
    (``"auto"``) resolves via :func:`repro_torch.service.store.default_store`
    (honouring ``CIM_TUNER_RESULT_STORE`` / the disable env var).
    """

    def __init__(
        self,
        engine: ExplorationEngine | None = None,
        store: ResultStore | None | str = "auto",
        config: QueueConfig = QueueConfig(),
        *,
        device="cuda",
        dtype: torch.dtype = torch.float32,
    ):
        """Build the queue over ``engine`` (or, lazily, the default
        engine for ``device`` and ``dtype``); no thread starts before the
        first submission."""
        self._engine = engine
        if engine is None:
            self.device: torch.device = resolve_device(device)
            self.dtype = dtype
        else:
            self.device, self.dtype = engine.device, engine.dtype
        #: held by the worker around every engine call; anything else that
        #: launches kernels on this queue's device takes it too
        self.engine_lock = threading.Lock()
        self.store = default_store() if store == "auto" else store
        self.config = config
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._pending: list[_Entry] = []
        self._inflight: dict[str, _Entry] = {}
        self._thread: threading.Thread | None = None
        self._closed = False
        self._holds = 0
        self._seq = 0
        # legacy-shaped per-instance counters mirrored into the
        # process-wide registry; StatCounters carries its own lock, so
        # bump() is safe from submitter threads AND the worker thread
        self.stats = obs.StatCounters({
            "submitted": _M_SUBMITTED.labels(),
            "store_hits": _M_STORE_HITS.labels(),
            "inflight_dedup": _M_INFLIGHT_DEDUP.labels(),
            "dispatches": _M_DISPATCHES.labels(),
            "completed": _M_COMPLETED.labels(),
            "failed": _M_FAILED.labels(),
        })
        # scheduler counters live in their own /v1/stats section so the
        # legacy "queue" shape stays exactly as pre-scheduler clients
        # (and the CI fleet smoke) expect it
        self.sched_stats = obs.StatCounters({
            "admitted": _M_SCHED_ADMISSIONS.labels(),
            "admission_checks": _M_SCHED_CHECKS.labels(),
        })
        self._running_group: list[_Entry] | None = None

    # ------------------------------------------------------------- #
    # engine access (lazy: store-only submissions never build one)
    # ------------------------------------------------------------- #
    @property
    def engine(self) -> ExplorationEngine:
        """The serving engine (the default one for the queue's device and
        dtype, built on first use)."""
        if self._engine is None:
            self._engine = default_engine(self.device, self.dtype)
        return self._engine

    # ------------------------------------------------------------- #
    # submission API
    # ------------------------------------------------------------- #
    def submit(
        self,
        job: ExploreJob,
        method: str | None = None,
        sa_settings: SASettings | None = None,
        priority: int = 0,
        meta=None,
        settings=None,
        fidelity: str | None = None,
    ) -> ExploreFuture:
        """Admit one exploration job; returns immediately with a future.

        ``method`` is any registered ``repro_torch.search`` backend name or
        ``"exhaustive"`` (``None`` uses ``job.search_method``);
        ``settings`` carries the backend's settings object
        (``sa_settings`` is the legacy SA spelling; ``None`` falls back
        to the job's own ``search_settings``, then backend defaults);
        ``fidelity`` ("analytic" | "measured" | shorthand "two")
        overrides the settings' fidelity for fidelity-capable backends
        (the portfolio racer)."""
        # resolve the effective settings WITHOUT instantiating the default
        # engine (store-only submissions skip engine construction and its
        # persistent-cache setup); a default-constructed engine uses
        # SASettings() too, so the canonical key matches either way
        method, settings, key = _normalize_submit_args(
            job, method, settings, sa_settings, fidelity,
            engine=self._engine, dtype=self.dtype)
        future = ExploreFuture(job, method, key, meta=meta)
        # submissions arrive from concurrent threads (the HTTP front
        # door); StatCounters locks each bump so increments never race
        self.stats.bump("submitted")

        if self.store is not None:
            cached = self.store.get(key)
            if cached is not None:
                self.stats.bump("store_hits")
                future._finish(cached, source="store")
                return future

        self._enqueue("explore", key, job, method, settings, None,
                      priority, future)
        return future

    def submit_many(
        self,
        jobs: typing.Sequence[ExploreJob],
        method: str | None = None,
        sa_settings: SASettings | None = None,
        priority: int = 0,
        metas: typing.Sequence | None = None,
        settings=None,
        fidelity: str | None = None,
    ) -> list[ExploreFuture]:
        """Admit a job batch; one future per job, in order."""
        metas = metas if metas is not None else [None] * len(jobs)
        if len(metas) != len(jobs):
            raise ValueError(
                f"metas length {len(metas)} != jobs length {len(jobs)}")
        with self.holding():
            return [self.submit(j, method, sa_settings, priority, meta=m,
                                settings=settings, fidelity=fidelity)
                    for j, m in zip(jobs, metas)]

    @contextlib.contextmanager
    def holding(self) -> typing.Iterator[None]:
        """Keep the micro-batch window from opening while the caller
        admits a batch: the worker starts its window only once every hold
        is released, so one window takes the whole batch however long its
        keying and store probes take.  A running group still admits
        pending entries at its rung boundaries."""
        with self._cv:
            self._holds += 1
        try:
            yield
        finally:
            with self._cv:
                self._holds -= 1
                self._cv.notify_all()

    def submit_values(
        self,
        job: ExploreJob,
        candidates: np.ndarray,
        priority: int = 0,
        meta=None,
    ) -> ExploreFuture:
        """Admit an explicit candidate sweep (the Pareto path); the future
        resolves to the ``[C]`` objective-value array."""
        rows = np.asarray(candidates, dtype=np.float64)
        key = values_key(job, rows, self.dtype)
        future = ExploreFuture(job, "values", key, meta=meta)
        self.stats.bump("submitted")
        self._enqueue("values", key, job, "values", None, rows,
                      priority, future)
        return future

    def run_sync(
        self,
        jobs: typing.Sequence[ExploreJob],
        method: str | None = None,
        sa_settings: SASettings | None = None,
        timeout: float | None = None,
        settings=None,
        fidelity: str | None = None,
    ) -> list[ExploreResult]:
        """Blocking batch call with service semantics (store, dedup) --
        what the ``co_explore`` family uses under the hood."""
        futures = self.submit_many(jobs, method, sa_settings,
                                   settings=settings, fidelity=fidelity)
        return [f.result(timeout) for f in futures]

    # ------------------------------------------------------------- #
    # introspection (the HTTP front door's /v1/stats)
    # ------------------------------------------------------------- #
    def depth(self) -> dict:
        """Instantaneous queue depth: submissions still waiting for a
        micro-batch plus keys currently being evaluated (also exported as
        the ``cim_queue_depth`` gauge)."""
        with self._lock:
            d = {"pending": len(self._pending),
                 "inflight": len(self._inflight)}
        _M_DEPTH.set(d["pending"], state="pending")
        _M_DEPTH.set(d["inflight"], state="inflight")
        return d

    def stats_snapshot(self) -> dict:
        """One JSON-able view of queue + scheduler + store + engine
        counters (engine stats appear only once an engine was actually
        instantiated).  The ``scheduler`` section carries the
        continuous-batching state: cumulative rung admissions and polls,
        plus the in-flight group depth (groups inside an engine call and
        the job count of the running group, admissions included)."""
        out: dict = {"queue": {**self.stats.snapshot(), **self.depth()}}
        with self._lock:
            running = self._running_group
            group_jobs = len(running) if running is not None else 0
        out["scheduler"] = {
            **self.sched_stats.snapshot(),
            "continuous": bool(self.config.continuous),
            "inflight_groups": 1 if running is not None else 0,
            "inflight_group_jobs": group_jobs,
        }
        out["store"] = dict(self.store.stats) \
            if self.store is not None else None
        out["engine"] = self._engine.stats_snapshot() \
            if self._engine is not None else None
        return out

    # ------------------------------------------------------------- #
    # lifecycle
    # ------------------------------------------------------------- #
    def close(self, timeout: float | None = None) -> None:
        """Reject new submissions, drain everything admitted, then stop
        the worker thread.

        Close is a DRAIN, not an abort: entries already queued when the
        flag flips are still dispatched (the worker loops until pending
        is empty, skipping the accumulation window once closed), and a
        race in flight keeps absorbing compatible pending entries at its
        rung boundaries -- so shutdown under active load resolves every
        accepted future instead of stranding whatever the window timer
        had not yet collected.  ``timeout=None`` (the default) waits for
        the full drain; pass a number to give up waiting after that many
        seconds (the daemon worker keeps draining in the background)."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()
            thread = self._thread
        if thread is not None:
            thread.join(timeout)

    def __enter__(self):
        """Context-manager support: ``with JobQueue(...) as q:``."""
        return self

    def __exit__(self, *exc):
        """Drain and stop on context exit (see :meth:`close`)."""
        self.close()

    # ------------------------------------------------------------- #
    # internals
    # ------------------------------------------------------------- #
    def _enqueue(self, kind, key, job, method, settings, payload,
                 priority, future) -> None:
        with self._cv:
            if self._closed:
                raise RuntimeError("service queue is closed")
            entry = self._inflight.get(key)
            if entry is not None:
                entry.futures.append(future)
                self.stats.bump("inflight_dedup")
                return
            self._seq += 1
            entry = _Entry(priority, self._seq, kind, key, job, method,
                           settings, payload, future)
            self._pending.append(entry)
            self._inflight[key] = entry
            _M_DEPTH.set(len(self._pending), state="pending")
            _M_DEPTH.set(len(self._inflight), state="inflight")
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._worker, name="cim-tuner-dse-queue",
                    daemon=True)
                self._thread.start()
            self._cv.notify_all()

    def _worker(self) -> None:
        with _device_scope(self.device):
            self._serve()

    def _serve(self) -> None:
        while True:
            with self._cv:
                while (not self._pending or self._holds) and \
                        not self._closed:
                    self._cv.wait()
                if not self._pending and self._closed:
                    return
                # micro-batch window: let near-simultaneous submissions
                # (NAS-style callers, sweep loops) coalesce into one batch
                deadline = time.monotonic() + self.config.batch_window_s
                while len(self._pending) < self.config.max_batch_jobs:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0 or self._closed:
                        break
                    self._cv.wait(remaining)
                # max_batch_jobs is a hard cap per dispatch: the overflow
                # stays pending, where the continuous scheduler admits it
                # into the dispatched race at rung boundaries and the
                # window scheduler picks it up as the next bounded batch
                cap = max(1, self.config.max_batch_jobs)
                ordered = sorted(self._pending, key=_Entry.order)
                batch, self._pending = ordered[:cap], ordered[cap:]
                _M_DEPTH.set(len(self._pending), state="pending")
            _M_WINDOW.inc()
            try:
                with obs.span("queue.batch", jobs=len(batch)), \
                        self.engine_lock:
                    self._dispatch(batch)
            except Exception as exc:    # noqa: BLE001 -- worker must survive
                # reject whatever the dispatch didn't resolve (resolved
                # futures ignore the second _finish) and keep serving
                self._resolve_group(batch, None, exc)

    def _groups(self, batch: list[_Entry]) -> list[list[_Entry]]:
        """Group a micro-batch by batch signature; one engine call
        per group, dispatched in (priority, arrival) order.  Entries whose
        jobs can't even be bucketed (malformed space/workload) are
        rejected individually so one bad spec can't poison the batch."""
        groups: dict[tuple, list[_Entry]] = {}
        for e in batch:
            try:
                if e.bucket is None:
                    method = "exhaustive" if e.kind == "values" else e.method
                    e.bucket = (e.kind, e.method, e.settings,
                                self.engine.bucket_key(e.job, method))
            except Exception as exc:     # noqa: BLE001 -- reject this entry
                self._resolve_group([e], None, exc)
                continue
            groups.setdefault(e.bucket, []).append(e)
        return list(groups.values())

    def _admission_hook(self, group: list[_Entry]):
        """The continuous-batching admission callback for one in-flight
        group, or ``None`` when the group has no rung boundaries to admit
        at (admission needs a bandit-allocator portfolio race; halving
        culls across rungs and every other method is single-shot).

        The engine polls the callback between bandit waves ON the worker
        thread.  Under the queue lock it sweeps ``_pending`` for entries
        matching the group's exact ``(kind, method, settings, bucket)``
        signature and moves them into the group -- they never leave the
        in-flight dedup map, so duplicate submissions keep folding onto
        them, and ``_resolve_group`` later persists + resolves them
        exactly like window-dispatched entries (the engine appends their
        results in admission order).  Entries that fail bucketing stay
        pending for the window path to reject individually."""
        if not self.config.continuous:
            return None
        head = group[0]
        if head.kind != "explore" or head.method != "portfolio" or \
                getattr(head.settings, "allocator", None) != "bandit":
            return None
        sig = head.bucket

        def admit() -> list[tuple[ExploreJob, str]]:
            self.sched_stats.bump("admission_checks")
            taken: list[_Entry] = []
            cap = max(1, self.config.max_batch_jobs)
            with self._cv:
                if self._pending:
                    rest = []
                    for e in self._pending:
                        (taken if len(taken) < cap
                         and self._admissible(e, sig)
                         else rest).append(e)
                    if taken:
                        self._pending = rest
                        _M_DEPTH.set(len(self._pending), state="pending")
            if not taken:
                return []
            now = time.perf_counter()
            for e in taken:
                group.append(e)
                _M_WAIT_S.observe(now - e.t_submit)
            self.sched_stats.bump("admitted", len(taken))
            _M_SCHED_GROUP_JOBS.set(len(group))
            _LOG.debug("admitted %d job(s) into in-flight group %s",
                       len(taken), sig)
            return [(e.job, e.key) for e in taken]

        return admit

    def _admissible(self, e: _Entry, sig: tuple) -> bool:
        """Does pending entry ``e`` match an in-flight group signature?
        Settings compare by dataclass equality; the batch bucket is
        computed lazily (and cached on the entry) exactly as the window
        path's ``_groups`` would."""
        if e.kind != "explore" or e.method != sig[1] or \
                e.settings != sig[2]:
            return False
        try:
            if e.bucket is None:
                e.bucket = (e.kind, e.method, e.settings,
                            self.engine.bucket_key(e.job, e.method))
        except Exception:        # noqa: BLE001 -- window path rejects it
            return False
        return e.bucket == sig

    def _dispatch(self, batch: list[_Entry]) -> None:
        for group in self._groups(batch):
            self.stats.bump("dispatches")
            now = time.perf_counter()
            for e in group:
                _M_WAIT_S.observe(now - e.t_submit)
            _LOG.debug("dispatch %d job(s) kind=%s method=%s wait=%.3fs",
                       len(group), group[0].kind, group[0].method,
                       now - min(e.t_submit for e in group))
            with self._lock:
                self._running_group = group
            _M_SCHED_GROUPS.set(1)
            _M_SCHED_GROUP_JOBS.set(len(group))
            try:
                if group[0].kind == "values":
                    outs = self.engine.candidate_values(
                        [e.job for e in group], [e.payload for e in group])
                else:
                    # pass the canonical keys computed at submit time so
                    # the engine's dedup pass skips re-hashing; the
                    # admission hook (None for non-admittable groups)
                    # lets compatible late arrivals join mid-race, and
                    # the engine returns their results appended behind
                    # the dispatched entries' -- group grows in lockstep
                    admit = self._admission_hook(group)
                    kwargs = {} if admit is None else {"admit": admit}
                    outs = self.engine.run(
                        [e.job for e in group], method=group[0].method,
                        settings=group[0].settings,
                        keys=[e.key for e in group], **kwargs)
            except Exception as exc:              # noqa: BLE001 -- reject group
                self._resolve_group(group, None, exc)
                continue
            finally:
                with self._lock:
                    self._running_group = None
                _M_SCHED_GROUPS.set(0)
                _M_SCHED_GROUP_JOBS.set(0)
            self._resolve_group(group, outs, None)

    def _resolve_group(self, group, outs, exc) -> None:
        for i, e in enumerate(group):
            out = outs[i] if exc is None else None
            if exc is None and e.kind == "explore" and \
                    self.store is not None:
                # persist BEFORE leaving the in-flight map: an identical
                # submission always sees either the running entry or the
                # stored result, never a gap
                self.store.put(e.key, out)
                # the decision timeline (portfolio runs) lands next to
                # the result, so warm-store hits after a restart still
                # serve GET /v1/jobs/<key>/timeline
                timeline = obs.flight_recorder().timeline(e.key)
                if timeline is not None:
                    self.store.put_timeline(e.key, timeline)
                # measured-fidelity runs park their kernel measurement
                # records under the job key; they become the result's
                # .measurements.json sidecar (same lifecycle)
                records = obs.profile.take_measurements(e.key)
                if records is not None:
                    self.store.put_measurements(e.key, records)
            with self._lock:
                self._inflight.pop(e.key, None)
                futures = list(e.futures)
                _M_DEPTH.set(len(self._inflight), state="inflight")
            if exc is not None:
                self.stats.bump("failed")
                # surface the failure into every affected future, tagged
                # with ITS canonical key -- a bucket-wide engine error must
                # stay attributable per submission, not merely logged
                err = _tag_job_exc(exc, e.key)
                for f in futures:
                    f._finish(exc=err, source="engine")
                continue
            self.stats.bump("completed")
            for j, f in enumerate(futures):
                r = out
                if j > 0 and isinstance(out, ExploreResult):
                    r = clone_result(out)
                f._finish(r, source="engine" if j == 0 else "inflight")
