"""Kernels: the ``flash_attention`` and ``flash_attention_bwd`` kernels'
least time (``work.attention_fwd`` / ``attention_bwd`` per call, from the
cell's shapes, times the calls in the trace) over their device time in
the traced steps, in %."""
import re

from perfbench import work

FWD = re.compile(r"(?:^|\s)\(anonymous namespace\)::(?:t[cf]::)?flash_kernel\b")
DQ = re.compile(r"(?:^|\s)\(anonymous namespace\)::dq_kernel\b")
DKDV = re.compile(r"(?:^|\s)\(anonymous namespace\)::dkdv_kernel\b")


def read(record):
    summary = record["trace"]
    if summary is None:
        return None
    count = {k: [0, 0.0] for k in ("fwd", "dq", "dkdv")}
    for name, (n, sec) in summary.kernels.items():
        for key, pat in (("fwd", FWD), ("dq", DQ), ("dkdv", DKDV)):
            if pat.search(name):
                count[key][0] += n
                count[key][1] += sec
    seconds = sum(c[1] for c in count.values())
    if not seconds:
        return None
    cfg, tr = record["cell"].config, record["cell"].traffic
    bh, t, d = tr["batch"] * cfg["n_heads"], tr["seq_len"], cfg["head_dim"]
    fwd, fwd_by = work.attention_fwd(bh, t, d)
    bwd, bwd_by = work.attention_bwd(bh, t, d)
    bound = count["fwd"][0] * fwd + count["dq"][0] * bwd
    return 100.0 * bound / seconds, f"bound by {fwd_by} / {bwd_by}"
