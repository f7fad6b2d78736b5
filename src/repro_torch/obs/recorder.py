"""Per-job search flight recorder: structured decision timelines.

Every portfolio race the engine runs leaves a compact, JSON-able record
of HOW it spent its budget -- per-rung best-so-far, per-backend pulls
and bandit rewards, UCB scores and the chosen arm, device assignments,
dedup fan-out -- keyed by the job's canonical :func:`job_key`.  The
engine feeds the process-wide :func:`flight_recorder` alongside its
progress-bus events (same payloads, so the two reconcile exactly);
:func:`render_timeline` and :func:`regret_curve` read a timeline back.

Timeline shape (``TIMELINE_SCHEMA`` guards evolution)::

    {"schema": 1, "key": ..., "method": "portfolio",
     "allocator": "bandit", "backends": [...], "devices": 1,
     "device_map": {backend: device}, "total_evals": ..., "rungs": ...,
     "created_s": ..., "events": [{"phase": "race", "rung": 0,
        "best": ..., "backend_best": {...}, "pulls": {...},
        "rewards": {...}, "ucb": {...}, "chosen": ...}, ...,
        {"phase": "final", "winner": ..., "final": ..., ...}],
     "provenance": {"dedup_fanout": ...},
     "summary": {"winner": ..., "best": ..., "final": ..., "pulls": ...}}

Environment:

``CIM_TUNER_TIMELINE_BUFFER``
    How many per-job timelines the in-memory recorder retains (LRU,
    default 1024); the store-persisted copies are unaffected.
"""
from __future__ import annotations

import collections
import copy
import os
import threading
import time

__all__ = ["FlightRecorder", "flight_recorder", "render_timeline",
           "regret_curve", "TIMELINE_SCHEMA"]

#: bump when the timeline record layout changes shape
TIMELINE_SCHEMA = 1

_DEF_CAPACITY = 1024
_ENV_CAPACITY = "CIM_TUNER_TIMELINE_BUFFER"


class FlightRecorder:
    """Bounded LRU of per-job decision timelines (thread-safe)."""

    def __init__(self, capacity: int | None = None):
        if capacity is None:
            capacity = int(os.environ.get(_ENV_CAPACITY, _DEF_CAPACITY))
        self.capacity = max(1, int(capacity))
        self._lock = threading.Lock()
        self._timelines: collections.OrderedDict[str, dict] = \
            collections.OrderedDict()

    def start(self, key: str, **header) -> None:
        """Open (or reset) the timeline for one job key; ``header``
        carries the race-invariant fields (method, allocator, backends,
        devices, budget)."""
        tl = {"schema": TIMELINE_SCHEMA, "key": key, **header,
              "created_s": time.time(), "events": [], "provenance": {},
              "summary": None}
        with self._lock:
            self._timelines[key] = tl
            self._timelines.move_to_end(key)
            while len(self._timelines) > self.capacity:
                self._timelines.popitem(last=False)

    def event(self, key: str, payload: dict) -> None:
        """Append one decision event (a race wave or the final phase);
        no-op for keys without an open timeline."""
        with self._lock:
            tl = self._timelines.get(key)
            if tl is not None:
                tl["events"].append(copy.deepcopy(payload))

    def annotate(self, key: str, **fields) -> None:
        """Merge provenance facts (dedup fan-out, batch size, ...) into
        an open timeline; no-op for unknown keys."""
        with self._lock:
            tl = self._timelines.get(key)
            if tl is not None:
                tl["provenance"].update(copy.deepcopy(fields))

    def finish(self, key: str, **fields) -> None:
        """Close the timeline with its convergence summary."""
        with self._lock:
            tl = self._timelines.get(key)
            if tl is not None:
                tl["summary"] = copy.deepcopy(fields)

    def timeline(self, key: str) -> dict | None:
        """Deep-copied snapshot of one timeline (``None`` if unknown)."""
        with self._lock:
            tl = self._timelines.get(key)
            return copy.deepcopy(tl) if tl is not None else None

    def keys(self) -> list[str]:
        """Keys with an in-memory timeline, oldest first."""
        with self._lock:
            return list(self._timelines)

    def clear(self) -> None:
        """Drop every in-memory timeline (tests)."""
        with self._lock:
            self._timelines.clear()


# --------------------------------------------------------------------- #
# analysis + rendering
# --------------------------------------------------------------------- #
def regret_curve(timeline: dict) -> list[dict]:
    """``{"rung", "pulls", "regret"}`` per race rung, where regret is
    the rung's incumbent best minus the overall best the job ever
    reached (race and final phases included).  Rungs without a finite
    best are skipped."""
    events = timeline.get("events") or []
    bests = [ev.get("best") for ev in events
             if isinstance(ev.get("best"), (int, float))]
    finals = [ev.get("final") for ev in events
              if isinstance(ev.get("final"), (int, float))]
    if not bests:
        return []
    floor = min(bests + finals)
    curve = []
    for ev in events:
        if ev.get("phase") != "race" or \
                not isinstance(ev.get("best"), (int, float)):
            continue
        curve.append({
            "rung": ev.get("rung"),
            "pulls": int(sum((ev.get("pulls") or {}).values())),
            "regret": float(ev["best"]) - floor,
        })
    return curve


def _num(v, digits: int = 6) -> str:
    return "-" if not isinstance(v, (int, float)) else f"{v:.{digits}g}"


def render_timeline(timeline: dict, width: int = 28) -> str:
    """Deterministic human rendering of one timeline: the rung table, a
    regret-vs-budget bar curve, and a convergence summary.  Contains no
    wall-clock data, so fixed-seed runs render identically."""
    backends = list(timeline.get("backends") or [])
    lines = [
        f"job       {timeline.get('key', '?')}",
        f"method    {timeline.get('method', '?')} "
        f"allocator={timeline.get('allocator', '?')} "
        f"devices={timeline.get('devices', '?')}",
        f"backends  {', '.join(backends) or '?'}",
        f"budget    total_evals={timeline.get('total_evals', '?')} "
        f"rungs={timeline.get('rungs', '?')}",
    ]
    prov = timeline.get("provenance") or {}
    if prov:
        lines.append("provenance " + " ".join(
            f"{k}={prov[k]}" for k in sorted(prov)))

    events = timeline.get("events") or []
    races = [ev for ev in events if ev.get("phase") == "race"]
    if races:
        lines.append("")
        lines.append(f"{'rung':>4}  {'best':>12}  {'chosen':>10}  "
                     f"pulls({'/'.join(backends)})")
        for ev in races:
            pulls = ev.get("pulls") or {}
            lines.append(
                f"{ev.get('rung', '?'):>4}  {_num(ev.get('best')):>12}  "
                f"{ev.get('chosen') or '-':>10}  "
                f"{'/'.join(str(pulls.get(b, 0)) for b in backends)}")

    curve = regret_curve(timeline)
    if curve:
        lines.append("")
        lines.append("regret vs budget (pulls -> best-so-far - overall "
                     "best)")
        top = max(pt["regret"] for pt in curve) or 1.0
        for pt in curve:
            bar = "#" * int(round(width * pt["regret"] / top))
            lines.append(f"  {pt['pulls']:>5} {pt['regret']:>12.6g} "
                         f"|{bar}")

    summary = timeline.get("summary") or {}
    finals = [ev for ev in events if ev.get("phase") == "final"]
    final_ev = finals[-1] if finals else {}
    winner = summary.get("winner", final_ev.get("winner"))
    best = summary.get("best", final_ev.get("best"))
    final = summary.get("final", final_ev.get("final"))
    lines.append("")
    conv = "-"
    if curve:
        top = max(pt["regret"] for pt in curve)
        idx = next((i for i, pt in enumerate(curve)
                    if pt["regret"] <= 0.01 * top), None)
        if idx is not None:
            conv = f"rung {curve[idx]['rung']} of {len(curve)}"
    lines.append(f"converged {conv} (first rung with <= 1% of peak "
                 f"regret)")
    lines.append(f"winner    {winner or '?'} best={_num(best)} "
                 f"final={_num(final)}")
    return "\n".join(lines)


# --------------------------------------------------------------------- #
# the process-wide recorder
# --------------------------------------------------------------------- #
_RECORDER: FlightRecorder | None = None
_RECORDER_LOCK = threading.Lock()


def flight_recorder() -> FlightRecorder:
    """The process-wide :class:`FlightRecorder` the engine feeds (lazily
    built so env vars set by tests before first use are honoured)."""
    global _RECORDER
    if _RECORDER is None:
        with _RECORDER_LOCK:
            if _RECORDER is None:
                _RECORDER = FlightRecorder()
    return _RECORDER
