"""Reduction of a ``torch.profiler`` trace to what the per-layer metrics
read: the traced window, the device's busy time in it, each kernel's
launches and time by name, and the idle gaps with what the host was doing
in each (the harness span around it and the innermost host operation).

The trace is exported as a Chrome trace under ``TMPDIR``, read and
deleted; device activity is every event of the categories in
:data:`DEVICE_CATEGORIES`.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import tempfile

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
#: the harness's own spans around each call into the program's layers
SPANS = ("train.data", "train.step", "train.sync")
WINDOW_SPAN = "bench.traced_window"


@dataclasses.dataclass
class Summary:
    window_s: float
    busy_s: float
    kernels: dict            # name -> [launches, seconds]
    device_ops: list         # [(short name, seconds)], largest first
    idle_gaps: list          # [(span > host op, seconds)], longest first


def short_name(name: str, width: int = 64) -> str:
    """A kernel's name as one token: the return type dropped, every run of
    other characters than letters, digits, ``_``, ``:`` and ``.`` made one
    ``_``, cut to ``width``."""
    name = re.sub(r"^void\s+", "", name)
    return re.sub(r"[^A-Za-z0-9_:.]+", "_", name)[:width]


def _merge(intervals: list) -> list:
    out: list = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _innermost(events: list, t: float):
    """The shortest event that spans time ``t``, or None."""
    best = None
    for e in events:
        if e["ts"] <= t <= e["ts"] + e["dur"] and (
                best is None or e["dur"] < best["dur"]):
            best = e
    return best


def summarize(events: list, top: int = 10) -> Summary:
    """The summary of Chrome-trace events (times in microseconds) within
    the harness's :data:`WINDOW_SPAN`."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    notes = [e for e in xs if e.get("cat") == "user_annotation"]
    wins = [e for e in notes if e.get("name") == WINDOW_SPAN]
    if not wins:
        raise ValueError(f"the trace has no {WINDOW_SPAN!r} span")
    w0 = wins[0]["ts"]
    w1 = w0 + wins[0]["dur"]
    inside = lambda e: e["ts"] < w1 and e["ts"] + e["dur"] > w0
    dev = [e for e in xs if e.get("cat") in DEVICE_CATEGORIES and inside(e)]
    busy = _merge([[max(e["ts"], w0), min(e["ts"] + e["dur"], w1)]
                   for e in dev])
    kernels: dict = {}
    for e in dev:
        if e["cat"] == "kernel":
            k = kernels.setdefault(e["name"], [0, 0.0])
            k[0] += 1
            k[1] += e["dur"] * 1e-6
    by_short: dict = {}
    for e in dev:
        key = short_name(e["name"])
        by_short[key] = by_short.get(key, 0.0) + e["dur"] * 1e-6
    spans = [e for e in notes if e.get("name") in SPANS and inside(e)]
    tids = {e.get("tid") for e in spans}
    host = [e for e in xs if e.get("cat") == "cpu_op" and e.get("tid") in tids
            and inside(e)]
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = sorted(((a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a),
                  key=lambda g: g[0] - g[1])[:top]
    idle = []
    for a, b in gaps:
        span = _innermost(spans, (a + b) / 2)
        op = _innermost(host, (a + b) / 2)
        label = (span["name"] if span else "outside spans") + \
            (" > " + op["name"] if op else "")
        idle.append((label[:64], (b - a) * 1e-6))
    return Summary(
        window_s=(w1 - w0) * 1e-6,
        busy_s=sum(b - a for a, b in busy) * 1e-6,
        kernels=kernels,
        device_ops=sorted(by_short.items(), key=lambda kv: -kv[1])[:top],
        idle_gaps=idle)


def read_profile(prof) -> Summary:
    """Export ``prof`` (a stopped ``torch.profiler.profile``) under
    ``TMPDIR``, summarize it and delete the file."""
    fd, path = tempfile.mkstemp(prefix="perfbench-trace-", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.remove(path)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return summarize(events)
