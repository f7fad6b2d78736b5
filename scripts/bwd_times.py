#!/usr/bin/env python3
"""Time the port's backward kernels of one tree on one CUDA card, kernel
by kernel, so that two trees can be compared in one call.

    python3 scripts/bwd_times.py [--kernels flash_attention_bwd,selective_scan_bwd]

It times the kernels of the ``repro_torch`` package under this checkout's
``src`` at phase 15.a's cases (``chip_smoke.ATTN_BWD_CASES`` and
``SCAN_BWD_CASES``, on the same seeded inputs): per call and from a CUDA
graph (CUDA events), and each kernel that a call launches (its device
time in torch.profiler over 5 calls), beside the call's bound.  To time another commit, unpack
it (``git archive <commit> | tar -x -C build/other``), copy this script
into that tree's ``scripts/`` and run it there.  Run the two trees in
turns (A, B, B, A) on one card and compare only within that session.

It uses only what every tree with the training path has
(``ops.flash_attention_bwd``, ``ops.selective_scan_bwd`` and the helpers
of ``chip_smoke.py``).  The last line is a JSON record of every row.
"""
from __future__ import annotations

import argparse
import functools
import json
import re
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402  (puts ROOT/src on the path)


def kernel_split_ms(torch, fn, calls: int = 5) -> dict[str, float]:
    """Device time a call of each kernel that ``fn`` launches, by its name
    and template arguments (``dq_kernel<128>``), from torch.profiler over
    ``calls`` calls (only the device traced); empty where the trace holds
    no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as trace:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    split: dict[str, float] = {}
    for e in trace.key_averages():
        m = re.search(r"(\w+_kernel(?:<[^>]*>)?)", e.key)
        if e.device_type == torch.autograd.DeviceType.CUDA and m:
            name = m.group(1).replace(" ", "")
            split[name] = split.get(name, 0.0) + \
                e.self_device_time_total / 1e3 / calls
    return split


def time_case(torch, kernel, call, args, kw, label, card) -> dict:
    """One backward call's times, per call, from a graph and by kernel."""
    ms, g_ms = cs.timed_ms(torch, call), cs.graph_ms(torch, call)
    split = kernel_split_ms(torch, call)
    b_ms, b_by = cs.bwd_bound_ms(kernel, args, kw)
    print(f"[{kernel}] {label}: {ms:.4f} ms per call, graph "
          + (f"{g_ms:.4f} ms" if g_ms is not None else "none")
          + "; its kernels " + (", ".join(
              f"{k} {v:.4f} ms" for k, v in sorted(split.items()))
              or "not measured") + " (torch.profiler); bound "
          f"{b_ms:.4f} ms ({b_by}); {card}", flush=True)
    return dict(label=label, ms=ms, graph_ms=g_ms, kernel_ms=split,
                bound_ms=b_ms, bound_by=b_by)


def main() -> None:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--kernels",
                        default="flash_attention_bwd,selective_scan_bwd",
                        help="comma-separated backward kernels to time")
    kernels = parser.parse_args().kernels.split(",")
    if not torch.cuda.is_available():
        cs.fail("no CUDA card: torch.cuda.is_available() is false")
    from repro_torch.kernels import ops, ref

    dev = torch.device("cuda")
    card = cs.card_line()
    print(f"{card}; {ROOT / 'src'}", flush=True)
    rows: dict[str, list] = {k: [] for k in kernels}
    if "flash_attention_bwd" in kernels:
        rng = np.random.default_rng(15)
        for bh, t, s, d, causal, what in cs.ATTN_BWD_CASES:
            args = cs.attn_bwd_args(torch, ops, ref, rng, dev, bh, t, s, d,
                                    causal)
            kw = {"causal": causal}
            rows["flash_attention_bwd"].append(time_case(
                torch, "flash_attention_bwd",
                functools.partial(ops.flash_attention_bwd, *args, **kw),
                args, kw, f"{what} {bh}x{t}x{s}x{d} causal={causal}", card))
            del args
    if "selective_scan_bwd" in kernels:
        rng = np.random.default_rng(15)
        for b, t, i, s, what in cs.SCAN_BWD_CASES:
            args = cs.scan_bwd_args(torch, rng, dev, b, t, i, s)
            rows["selective_scan_bwd"].append(time_case(
                torch, "selective_scan_bwd",
                functools.partial(ops.selective_scan_bwd, *args), args, {},
                f"{what} {b}x{t}x{i}x{s}", card))
            del args
    print(json.dumps(rows))


if __name__ == "__main__":
    main()
