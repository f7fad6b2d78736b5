#!/usr/bin/env python3
"""The host cost of one ``obs`` span of a tree: ``with span(name): pass``,
timed call by call with ``time.perf_counter_ns`` (the clock's own cost is
in every reading), the median of ``--calls`` calls, with no profiler
running and inside a ``torch.profiler`` profile (CPU activity, and CUDA
where there is a card, as the benchmark's traced runs profile).

    python3 scripts/span_cost.py [--root .] [--calls 100000]

``--root`` names the tree whose ``src/repro_torch`` is timed: to compare
with another commit, unpack it (``git archive <commit> | tar -x -C
build/other``) and pass ``--root build/other``; run both on one machine, in
turns.  The last line is a JSON record, in microseconds.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path


def median_us(span, calls: int) -> float:
    clock = time.perf_counter_ns
    took = []
    for _ in range(calls):
        t0 = clock()
        with span("cost.probe"):
            pass
        took.append(clock() - t0)
    return statistics.median(took) * 1e-3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--calls", type=int, default=100_000)
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root / "src"))
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.obs import trace

    tracer = trace.Tracer(capacity=8192, jsonl_path="")
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    median_us(tracer.span, 1000)                      # warm
    off = median_us(tracer.span, args.calls)
    with profile(activities=acts):
        on = median_us(tracer.span, args.calls)
    print(json.dumps({"root": str(root), "calls": args.calls,
                      "span_us_profiler_off": off,
                      "span_us_profiler_on": on,
                      "device": torch.cuda.get_device_name(0)
                      if torch.cuda.is_available() else "cpu"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
