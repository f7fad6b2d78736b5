"""Futures and streaming iterators for the port's DSE service.

``JobQueue.submit`` returns an :class:`ExploreFuture`; :func:`as_completed`
turns any collection of them into an iterator that yields each future the
moment its micro-batch bucket finishes -- callers see the fast bucket's
results while the slow bucket is still annealing.  :func:`stream_pareto`
builds on the same machinery to stream per-workload Pareto frontiers.

Under the continuous-batching scheduler (``service/queue.py``) a future may
resolve from *inside* another group's engine call: a submission admitted
at a rung boundary rides the in-flight race and its future resolves when
that race's group drains.  Nothing changes for consumers -- ``source``
still reads ``"engine"`` and every future resolves exactly once -- but
arrival order and resolution order decouple further than window batching
alone allowed, which is why every iterator here keys on completion
events rather than submission order.

The port's copy of the reference's ``service/streams.py``; only
:func:`stream_pareto` gains the port's ``device`` / ``dtype`` for the
default service it falls back to.
"""
from __future__ import annotations

import queue as _queue
import threading
import typing

import torch

if typing.TYPE_CHECKING:                             # pragma: no cover
    from repro_torch.core.engine import ExploreJob

__all__ = ["ExploreFuture", "as_completed", "stream_results",
           "stream_pareto"]


class ExploreFuture:
    """Single-job handle: resolves to an ``ExploreResult`` (explore jobs)
    or an ``np.ndarray`` of objective values (candidate-sweep jobs).

    ``source`` records where the result came from once done:
    ``"engine"`` (evaluated), ``"store"`` (persistent cache hit) or
    ``"inflight"`` (deduped onto an identical pending submission).
    """

    def __init__(self, job: "ExploreJob", method: str, key: str,
                 meta=None):
        self.job = job
        self.method = method
        self.key = key
        self.meta = meta                 # caller tag, round-tripped as-is
        self.source: str | None = None
        self._event = threading.Event()
        self._result = None
        self._exc: BaseException | None = None
        self._callbacks: list = []
        self._lock = threading.Lock()

    # ------------------------------------------------------------- #
    # consumer side
    # ------------------------------------------------------------- #
    def done(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout: float | None = None) -> bool:
        """Block until resolved (or ``timeout``); returns ``done()``.
        Unlike :meth:`result` this never raises -- the HTTP front door's
        long-poll path uses it to report failed jobs as data."""
        return self._event.wait(timeout)

    def result(self, timeout: float | None = None):
        if not self._event.wait(timeout):
            raise TimeoutError(f"job {self.key[:12]} not done "
                               f"after {timeout}s")
        if self._exc is not None:
            raise self._exc
        return self._result

    def exception(self, timeout: float | None = None):
        if not self._event.wait(timeout):
            raise TimeoutError(f"job {self.key[:12]} not done "
                               f"after {timeout}s")
        return self._exc

    def add_done_callback(self, fn) -> None:
        """``fn(future)`` runs when the future resolves (immediately if it
        already has); exceptions in callbacks are swallowed."""
        with self._lock:
            if not self._event.is_set():
                self._callbacks.append(fn)
                return
        try:
            fn(self)
        except Exception:
            pass

    @classmethod
    def completed(
        cls,
        job,
        method: str,
        key: str,
        result=None,
        exc: BaseException | None = None,
        source: str = "store",
        meta=None,
    ) -> "ExploreFuture":
        """An already-resolved future -- how the HTTP server represents
        store-backed results and how the remote client materializes
        local-tier cache hits without touching a queue."""
        fut = cls(job, method, key, meta=meta)
        fut._finish(result, exc=exc, source=source)
        return fut

    # ------------------------------------------------------------- #
    # producer side (the queue worker)
    # ------------------------------------------------------------- #
    def _finish(self, result=None, exc: BaseException | None = None,
                source: str = "engine") -> None:
        with self._lock:
            if self._event.is_set():
                return                      # first resolution wins
            self._result = result
            self._exc = exc
            self.source = source
            self._event.set()
            callbacks, self._callbacks = self._callbacks, []
        for fn in callbacks:
            try:
                fn(self)
            except Exception:
                pass


def as_completed(
    futures: typing.Iterable[ExploreFuture],
    timeout: float | None = None,
) -> typing.Iterator[ExploreFuture]:
    """Yield futures in completion order (first finished bucket first).

    ``timeout`` is an overall deadline for the whole collection, matching
    ``concurrent.futures.as_completed`` semantics."""
    import time

    futures = list(futures)
    done: _queue.SimpleQueue = _queue.SimpleQueue()
    for f in futures:
        f.add_done_callback(done.put)
    deadline = None if timeout is None else time.monotonic() + timeout
    for _ in range(len(futures)):
        try:
            remaining = None if deadline is None \
                else max(0.0, deadline - time.monotonic())
            yield done.get(timeout=remaining)
        except _queue.Empty:
            raise TimeoutError(
                f"{len(futures)} futures not all done after {timeout}s"
            ) from None


def stream_results(
    futures: typing.Iterable[ExploreFuture],
    timeout: float | None = None,
) -> typing.Iterator[tuple]:
    """Yield ``(meta, result)`` pairs in completion order; failed jobs
    re-raise at their position in the stream."""
    for f in as_completed(futures, timeout=timeout):
        yield f.meta, f.result()


def stream_pareto(
    macro,
    workloads: typing.Sequence,
    area_budget_mm2: float,
    *,
    service=None,
    strategy_set: str = "st",
    space=None,
    bw: int = 256,
    timeout: float | None = None,
    device="cuda",
    dtype: torch.dtype = torch.float32,
) -> typing.Iterator[tuple]:
    """Stream per-workload EE/Th Pareto frontiers: yields
    ``(workload_name, frontier)`` as each workload's candidate sweep
    completes.  All ``2 x len(workloads)`` sweep jobs go through the
    service queue, so overlapping submissions from other callers share
    batches and dedup.  Without ``service`` it is the process-wide
    :func:`~repro_torch.service.client.default_service` for ``device``
    and ``dtype``."""
    import numpy as np

    from repro_torch.core.engine import ExploreJob
    from repro_torch.core.explorer import pareto_frontier_from_values
    from repro_torch.core.pruning import (DesignSpace, candidates_with_bw,
                                          prune_space)

    if service is None:
        from repro_torch.service.client import default_service
        service = default_service(device, dtype)

    space = space or DesignSpace()
    # candidate pruning depends only on (space, macro, budget, bw) -- one
    # prune serves every workload
    cands, _ = prune_space(space, macro, area_budget_mm2, bw)
    if len(cands) == 0:
        raise ValueError("no feasible hardware point under budget")
    rows = candidates_with_bw(cands, bw)

    futures = []
    per_wl: dict[str, dict] = {}
    for wl in workloads:
        per_wl[wl.name] = {"pending": 2, "vals": {}}
        for obj in ("th", "ee"):
            job = ExploreJob(
                macro=macro, workload=wl, area_budget_mm2=area_budget_mm2,
                objective=obj, strategy_set=strategy_set, bw=bw, space=space)
            futures.append(service.submit_values(
                job, rows, meta=(wl.name, obj)))

    wl_by_name = {wl.name: wl for wl in workloads}
    for f in as_completed(futures, timeout=timeout):
        name, obj = f.meta
        st = per_wl[name]
        st["vals"][obj] = np.asarray(f.result())
        st["pending"] -= 1
        if st["pending"] == 0:
            yield name, pareto_frontier_from_values(
                cands, st["vals"]["th"], st["vals"]["ee"],
                wl_by_name[name], macro, bw)
