"""Span tracer: timed sections -> ring buffer -> Chrome trace_event.

The port's copy of the reference's ``obs/trace.py`` (stdlib only).

``with span("engine.compile", bucket=key):`` times a section, records it
as a completed-event dict in a bounded in-memory ring buffer, optionally
appends it as JSONL to ``$CIM_TUNER_TRACE``, and (when the span was given
a histogram) feeds the duration into the metrics registry -- one
instrumentation point serves both the trace timeline and the latency
distributions.

Events are stored directly in Chrome ``trace_event`` shape (``ph: "X"``
complete events, ``ts``/``dur`` in microseconds), so export is a thin
wrapper: :func:`chrome_trace` returns a
``{"traceEvents": [...]}`` document Perfetto / ``chrome://tracing`` loads
as-is.

Spans reach a running ``torch.profiler`` too: while one is active, a span
also enters ``torch.autograd.profiler.record_function(name)``, so it lands
in the profiler's trace as a ``user_annotation`` event on the profiler's
clock, beside the kernels its section launched.  The check reads the
profiler's flag through ``sys.modules`` (this module imports no torch);
with no profiler running a span makes no torch call, so no CUDA call and
no synchronise.

Environment:

``CIM_TUNER_TRACE``
    Path; every finished span is appended there as one JSON line.
``CIM_TUNER_TRACE_BUFFER``
    Ring-buffer capacity (default 8192 spans); 0 disables buffering.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import sys
import threading
import time
import typing

__all__ = ["Span", "Tracer", "tracer", "span", "chrome_trace"]

_DEF_CAPACITY = 8192

#: process-unique span-id sequence (itertools.count increments atomically
#: under the GIL, so ids are race-free without a lock)
_SPAN_SEQ = itertools.count(1)


def _next_span_id() -> str:
    return f"{os.getpid():x}-{next(_SPAN_SEQ):x}"


class Span:
    """One in-flight timed section; attributes land in the event's
    ``args``.  ``span_id`` is the process-unique id the event carries in
    ``/v1/trace`` -- histogram exemplars reference it (see
    ``obs/metrics.py``)."""

    __slots__ = ("name", "cat", "args", "t0", "duration_s", "span_id")

    def __init__(self, name: str, cat: str, args: dict):
        self.name = name
        self.cat = cat
        self.args = args
        self.t0 = time.perf_counter()
        self.duration_s: float | None = None
        self.span_id = _next_span_id()

    def set(self, **kw) -> None:
        """Attach extra args discovered mid-span (e.g. result counts)."""
        self.args.update(kw)


def _profiler_note(name: str):
    """``record_function(name)`` while a torch profiler is running, else
    None."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.autograd.profiler._is_profiler_enabled:
        return None
    return torch.autograd.profiler.record_function(name)


class Tracer:
    """Bounded ring buffer of finished spans with optional JSONL sink."""

    def __init__(self, capacity: int | None = None,
                 jsonl_path: str | None = None):
        if capacity is None:
            capacity = int(os.environ.get("CIM_TUNER_TRACE_BUFFER",
                                          _DEF_CAPACITY))
        if jsonl_path is None:
            jsonl_path = os.environ.get("CIM_TUNER_TRACE") or None
        self.capacity = max(0, capacity)
        self.jsonl_path = jsonl_path
        self._lock = threading.Lock()
        self._events: collections.deque = collections.deque(
            maxlen=self.capacity or 1)
        self._pid = os.getpid()
        # epoch anchor so perf_counter offsets become absolute-ish ts
        self._epoch_us = time.time() * 1e6 - time.perf_counter() * 1e6

    @contextlib.contextmanager
    def span(self, name: str, *, cat: str = "repro",
             histogram=None, **args) -> typing.Iterator[Span]:
        """Time a ``with`` block as one complete trace event.

        ``histogram`` is an optional :class:`repro_torch.obs.metrics.Histogram`
        child or family (no labels) whose ``observe`` receives the span
        duration in seconds on exit, tagged with this span's id as an
        exemplar (so a latency outlier in ``/v1/metrics`` links back to
        its span in ``/v1/trace``).  Extra keyword args become the
        event's ``args`` payload.
        """
        sp = Span(name, cat, dict(args))
        note = _profiler_note(name)
        try:
            if note is None:
                yield sp
            else:
                with note:
                    yield sp
        finally:
            sp.duration_s = time.perf_counter() - sp.t0
            self._record(sp)
            if histogram is not None:
                try:
                    histogram.observe(sp.duration_s,
                                      exemplar={"span_id": sp.span_id})
                except TypeError:      # foreign histogram, no exemplars
                    histogram.observe(sp.duration_s)

    def _record(self, sp: Span) -> None:
        ev = {
            "name": sp.name,
            "cat": sp.cat,
            "id": sp.span_id,
            "ph": "X",
            "ts": round(self._epoch_us + sp.t0 * 1e6, 3),
            "dur": round(sp.duration_s * 1e6, 3),
            "pid": self._pid,
            "tid": threading.get_ident() & 0x7FFFFFFF,
            "args": sp.args,
        }
        if self.capacity:
            with self._lock:
                self._events.append(ev)
        if self.jsonl_path:
            line = json.dumps(ev, default=str)
            with self._lock:
                try:
                    with open(self.jsonl_path, "a") as f:
                        f.write(line + "\n")
                except OSError:
                    # tracing must never take the workload down
                    self.jsonl_path = None

    def events(self) -> list[dict]:
        """Snapshot of the buffered events, oldest first."""
        with self._lock:
            return list(self._events)

    def clear(self) -> None:
        """Drop all buffered events (tests)."""
        with self._lock:
            self._events.clear()


def chrome_trace(events: typing.Iterable[dict]) -> dict:
    """Wrap raw span events as a Chrome/Perfetto trace document."""
    return {"traceEvents": list(events), "displayTimeUnit": "ms"}


# --------------------------------------------------------------------- #
# the process-wide tracer
# --------------------------------------------------------------------- #
_TRACER: Tracer | None = None
_TRACER_LOCK = threading.Lock()


def tracer() -> Tracer:
    """The process-wide :class:`Tracer` (lazily built so env vars set by
    tests before first use are honoured)."""
    global _TRACER
    if _TRACER is None:
        with _TRACER_LOCK:
            if _TRACER is None:
                _TRACER = Tracer()
    return _TRACER


def span(name: str, *, cat: str = "repro", histogram=None, **args):
    """``tracer().span(...)`` shorthand -- the one-liner subsystems use."""
    return tracer().span(name, cat=cat, histogram=histogram, **args)
