"""Kernels: the ``flash_attention`` and ``flash_attention_bwd`` kernels'
least time on latent attention, counted at the true widths
(``mla_work.attention_fwd`` / ``attention_bwd`` per call: query/key
dn + dr, value dv), times the calls in the trace, over their device time
in the traced steps, in %.  The note gives the bound that holds and the
compiled width the calls ran at."""
import re

from perfbench import mla_work

FWD = re.compile(r"(?:^|\s)\(anonymous namespace\)::(?:t[cf]::)?flash_kernel\b")
DQ = re.compile(r"(?:^|\s)\(anonymous namespace\)::dq_kernel\b")
DKDV = re.compile(r"(?:^|\s)\(anonymous namespace\)::dkdv_kernel\b")


def read(record):
    summary = record["trace"]
    cfg, tr = record["cell"].config, record["cell"].traffic
    if summary is None or not cfg.get("kv_lora_rank"):
        return None
    calls, seconds = {"fwd": 0, "dq": 0}, 0.0
    for name, (n, sec) in summary.kernels.items():
        for key, pat in (("fwd", FWD), ("dq", DQ), ("dkdv", DKDV)):
            if pat.search(name):
                calls[key] = calls.get(key, 0) + n
                seconds += sec
    if not seconds:
        return None
    dqk = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
    shape = (tr["batch"] * cfg["n_heads"], tr["seq_len"], dqk,
             cfg["v_head_dim"])
    fwd, fwd_by = mla_work.attention_fwd(*shape)
    bwd, bwd_by = mla_work.attention_bwd(*shape)
    width = next(w for w in (64, 128, 256) if dqk <= w)
    return 100.0 * (calls["fwd"] * fwd + calls["dq"] * bwd) / seconds, \
        f"bound by {fwd_by} / {bwd_by}; widths {dqk} / {cfg['v_head_dim']} " \
        f"run at the compiled width {width}"
