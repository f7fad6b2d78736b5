"""Attribution of a traced run's device work to the program's own spans.

The port's ``obs`` spans enter ``record_function`` while a torch profiler
runs, so they land in a traced run's Chrome trace as ``user_annotation``
events on the kernels' clock.  :func:`attribute` summarizes them by name,
within the harness's traced window: their calls and host time, the
kernels they launched (a kernel is matched to its launch, a
:data:`LAUNCH_CATEGORIES` event, by ``args.correlation``, and counts for
every span whose name covers the launch's time on any thread: the
autograd engine launches the backward and the remat recompute from a
thread of its own), the synchronising calls (:data:`SYNC_CALLS`) in them,
and the device's idle time under them.  Each count is also split by the
innermost program span (``self_syncs``, ``self_idle_s``); what no program
span covers is under :data:`OUTSIDE`.  :func:`readings` gives the
per-step numbers a reader of each would report.

The harness does not call this: ``trace.summarize`` keeps no event, so
wiring it in is an edit to ``perfbench/trace.py`` (``PERF.md`` §7).  Run
by hand, it runs one traced run of a cell as ``run.py --trace 1`` does and
prints the attribution as one JSON line:

    python3 perfbench/spans.py --workload yi-6b.train-1x16384 --seed 7
"""
from __future__ import annotations

import bisect
import json
import sys
from pathlib import Path

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from perfbench import trace  # noqa: E402

#: host events that launch device work, each with the device event's
#: ``args.correlation``
LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")
#: the calls that make the host wait for the card
SYNC_CALLS = ("cudaDeviceSynchronize", "cudaStreamSynchronize",
              "cudaEventSynchronize", "cudaMemcpy")
#: the key of what no program span covers: the trainer loop's own calls
#: and the harness's
OUTSIDE = "outside spans"
#: the share of the window's kernel time that may match no launch before
#: attributed device times are not read
UNATTRIBUTED_MAX = 0.01


def _end(e) -> float:
    return e["ts"] + e["dur"]


class _Cover:
    """The merged intervals of one span name: whether they cover a time,
    and how much of an interval they cover."""

    def __init__(self, events: list):
        self.ivs = trace._merge([[e["ts"], _end(e)] for e in events])
        self.starts = [a for a, _ in self.ivs]

    def covers(self, t: float) -> bool:
        i = bisect.bisect_right(self.starts, t) - 1
        return i >= 0 and t <= self.ivs[i][1]

    def overlap(self, a: float, b: float) -> float:
        i = max(bisect.bisect_right(self.starts, a) - 1, 0)
        out = 0.0
        while i < len(self.ivs) and self.ivs[i][0] < b:
            out += max(0.0, min(b, self.ivs[i][1]) - max(a, self.ivs[i][0]))
            i += 1
        return out


class _Innermost:
    """The timeline cut at every program span's ends, each piece owned by
    the shortest span over it (any thread), or by :data:`OUTSIDE`."""

    def __init__(self, events: list):
        inf = float("inf")
        self.bounds = [-inf] + sorted({x for e in events
                                       for x in (e["ts"], _end(e))}) + [inf]
        self.owner = []
        for a, b in zip(self.bounds, self.bounds[1:]):
            m = (a + b) / 2
            over = [e for e in events if e["ts"] <= m <= _end(e)]
            self.owner.append(min(over, key=lambda e: e["dur"])["name"]
                              if over else OUTSIDE)

    def at(self, t: float) -> str:
        return self.owner[bisect.bisect_right(self.bounds, t) - 1]

    def pieces(self, a: float, b: float):
        """(owner, length) of each piece of ``[a, b]``."""
        i = bisect.bisect_right(self.bounds, a) - 1
        while self.bounds[i] < b:
            lo, hi = max(a, self.bounds[i]), min(b, self.bounds[i + 1])
            if hi > lo:
                yield self.owner[i], hi - lo
            i += 1


def attribute(events: list) -> dict:
    """The program's spans in the traced window of Chrome-trace ``events``
    (times in microseconds): ``{"by_span": {name or OUTSIDE: {"calls",
    "host_s", "launches", "device_s", "syncs", "self_syncs", "idle_s",
    "self_idle_s"}}, "unattributed_s", "kernels_s", "busy_s",
    "window_s"}``, times in seconds."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    notes = [e for e in xs if e.get("cat") == "user_annotation"]
    wins = [e for e in notes if e.get("name") == trace.WINDOW_SPAN]
    if not wins:
        raise ValueError(f"the trace has no {trace.WINDOW_SPAN!r} span")
    w0, w1 = wins[0]["ts"], _end(wins[0])
    inside = lambda e: e["ts"] < w1 and _end(e) > w0
    program = [e for e in notes if inside(e) and e.get("name")
               not in trace.SPANS + (trace.WINDOW_SPAN,)]
    launches = [e for e in xs if e.get("cat") in LAUNCH_CATEGORIES]
    dev = [e for e in xs if e.get("cat") in trace.DEVICE_CATEGORIES
           and inside(e)]
    busy = trace._merge([[max(e["ts"], w0), min(_end(e), w1)] for e in dev])
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]

    names = sorted({e["name"] for e in program})
    cover = {n: _Cover([e for e in program if e["name"] == n]) for n in names}
    under = lambda t: [n for n in names if cover[n].covers(t)] or [OUTSIDE]
    inner = _Innermost(program)
    stats = {n: {"calls": 0, "host_s": 0.0, "launches": 0, "device_s": 0.0,
                 "syncs": 0, "self_syncs": 0, "idle_s": 0.0,
                 "self_idle_s": 0.0} for n in names + [OUTSIDE]}
    for e in program:
        stats[e["name"]]["calls"] += 1
        stats[e["name"]]["host_s"] += e["dur"] * 1e-6
    launched: dict = {}
    for e in launches:
        corr = e.get("args", {}).get("correlation")
        if corr is not None:
            launched.setdefault(corr, e["ts"])
    kernels_s = unattributed = 0.0
    for e in dev:
        if e["cat"] != "kernel":
            continue
        kernels_s += e["dur"] * 1e-6
        t = launched.get(e.get("args", {}).get("correlation"))
        if t is None:
            unattributed += e["dur"] * 1e-6
            continue
        for n in under(t):
            stats[n]["launches"] += 1
            stats[n]["device_s"] += e["dur"] * 1e-6
    for e in launches:
        if e["name"] in SYNC_CALLS and w0 <= e["ts"] <= w1:
            for n in under(e["ts"]):
                stats[n]["syncs"] += 1
            stats[inner.at(e["ts"])]["self_syncs"] += 1
    for a, b in gaps:
        for n in names:
            stats[n]["idle_s"] += cover[n].overlap(a, b) * 1e-6
        for owner, length in inner.pieces(a, b):
            stats[owner]["self_idle_s"] += length * 1e-6
    stats[OUTSIDE]["idle_s"] = stats[OUTSIDE]["self_idle_s"]
    return {"by_span": stats, "unattributed_s": unattributed,
            "kernels_s": kernels_s,
            "busy_s": sum(b - a for a, b in busy) * 1e-6,
            "window_s": (w1 - w0) * 1e-6}


def readings(att: dict, steps: int) -> dict:
    """Per traced step, each number a reader would report, with its note
    (a number is None where it is not to be read):
    ``forward_ms`` / ``backward_ms`` / ``remat_ms`` / ``optimizer_ms``, the
    device time launched under ``step.forward``, ``step.backward`` (remat
    included), ``model.remat`` and ``step.optimizer``; ``host_syncs``, the
    window's synchronising calls, split by innermost span in the note;
    ``step_idle_ms``, the device's idle time under the ``step.*`` spans;
    ``queue_wait_ms``, the host time of ``data.queue_get``."""
    by = att["by_span"]
    get = lambda name, key: by.get(name, {}).get(key, 0.0)
    if not set(by) - {OUTSIDE}:
        return {}
    gap = None
    if not att["kernels_s"]:
        gap = "no kernel in the traced window"
    elif att["unattributed_s"] > UNATTRIBUTED_MAX * att["kernels_s"]:
        gap = (f"{100 * att['unattributed_s'] / att['kernels_s']:.2f} % of "
               f"the kernels' time matched no launch (at most "
               f"{100 * UNATTRIBUTED_MAX:g} % is read)")
    per = lambda name, key, scale=1.0: scale * get(name, key) / steps
    out = {}
    fwd = get("step.forward", "device_s")
    share = lambda n: 100.0 * get(n, "device_s") / fwd if fwd else 0.0
    for key, name, note in (
            ("forward_ms", "step.forward",
             f"{per('step.forward', 'launches'):g} launches a step; "
             f"model.head {share('model.head'):.1f} %, "
             f"model.loss {share('model.loss'):.1f} %"),
            ("backward_ms", "step.backward",
             f"{per('step.backward', 'launches'):g} launches a step"),
            ("remat_ms", "model.remat",
             f"{per('model.remat', 'calls'):g} recomputes, "
             f"{per('model.remat', 'launches'):g} launches a step"),
            ("optimizer_ms", "step.optimizer",
             f"{per('step.optimizer', 'launches'):g} launches a step; "
             f"optim.apply {per('optim.apply', 'device_s', 1e3):.3f} ms")):
        out[key] = (None, gap) if gap or name not in by else \
            (per(name, "device_s", 1e3), note)
    split = sorted(((st["self_syncs"] / steps,
                     "trainer loop" if n == OUTSIDE else n)
                    for n, st in by.items() if st["self_syncs"]),
                   key=lambda x: (-x[0], x[1]))
    out["host_syncs"] = (sum(n for n, _ in split), ", ".join(
        f"{name} {n:g}" for n, name in split) or "none")
    step = [n for n in by if n.startswith("step.")]
    top = sorted(((st["self_idle_s"], n) for n, st in by.items()
                  if n != OUTSIDE), reverse=True)[:3]
    out["step_idle_ms"] = (
        1e3 * sum(by[n]["idle_s"] for n in step) / steps if step else None,
        ", ".join(f"{n} {1e3 * s / steps:.3f} ms" for s, n in top)
        + f"; outside spans {per(OUTSIDE, 'self_idle_s', 1e3):.3f} ms")
    out["queue_wait_ms"] = (
        per("data.queue_get", "host_s", 1e3) if "data.queue_get" in by
        else None,
        f"data.pin_copy {per('data.pin_copy', 'host_s', 1e3):.3f} ms a step")
    return out


def keep_events() -> tuple:
    """Have ``trace.summarize`` keep each trace's events in the returned
    list, in this process; the callable undoes it."""
    kept: list = []
    summarize = trace.summarize

    def keeping(events, top=10):
        kept.append(events)
        return summarize(events, top)
    trace.summarize = keeping

    def undo():
        trace.summarize = summarize
    return kept, undo


def main(argv=None) -> int:
    import argparse

    from perfbench import harness, run

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    args.trace = 1
    root = Path(__file__).resolve().parents[1]
    cell = harness.find_cell(args.workload, root)
    harness.set_cache_dirs(root)
    harness.need_program(root)
    harness.need_cards(cell.entry["chips"])
    kept, undo = keep_events()
    try:
        out = harness.driver(cell.traffic["kind"]).run(cell, args,
                                                       run.T_START)
    finally:
        undo()
    harness.guard_modules()
    steps = out.record["window"]["traced_steps"]
    att = attribute(kept[-1])
    print(json.dumps({"workload": args.workload, "seed": args.seed,
                      "traced_steps": steps, "device": out.device,
                      "step_s": out.noise["step_s"], "correct": out.correct,
                      "metrics": harness.result_line(cell, out, True)[
                          "metrics"],
                      "attribution": att,
                      "readings": readings(att, steps)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
