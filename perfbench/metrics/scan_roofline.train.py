"""Kernels: the ``selective_scan`` and ``selective_scan_bwd`` kernels'
least time (``work.scan_fwd`` / ``scan_bwd`` per call, from the cell's
shapes, times the calls in the trace: one ``scan_kernel`` launch a
forward call, one ``summary_kernel`` launch of four a backward call) over
their device time in the traced steps, in %."""
import re

from perfbench import work

FWD = re.compile(r"(?:^|\s)\(anonymous namespace\)::scan_kernel\b")
BWD = re.compile(r"(?:^|\s)\(anonymous namespace\)::"
                 r"(summary|combine|walk|reduce)_kernel\b")


def read(record):
    summary = record["trace"]
    if summary is None:
        return None
    fwd_calls, bwd_calls, seconds = 0, 0, 0.0
    for name, (n, sec) in summary.kernels.items():
        if FWD.search(name):
            fwd_calls += n
            seconds += sec
        elif m := BWD.search(name):
            bwd_calls += n if m.group(1) == "summary" else 0
            seconds += sec
    if not seconds:
        return None
    cfg, tr = record["cell"].config, record["cell"].traffic
    shape = (tr["batch"], tr["seq_len"], cfg["d_inner"], cfg["ssm_state"])
    fwd, fwd_by = work.scan_fwd(*shape)
    bwd, bwd_by = work.scan_bwd(*shape)
    return 100.0 * (fwd_calls * fwd + bwd_calls * bwd) / seconds, \
        f"bound by {fwd_by} / {bwd_by}"
