"""Planted faults in the ``flash_attention_bwd`` kernel, to show that its
checks catch a kernel that drops a far tile.

Each fault is planted in a copy of the repository made in a temporary
directory (the tree itself is never edited): the dk/dv pass skipping the
last q tile, and the dq pass writing zeros for the last q tile.  For each,
the copy's ``chip_smoke.check_bwd`` (the row-by-row bar of phase 15.a)
runs on 15.a's first two cases (yi-6b's layer 32x4096x4096x128 causal,
and 4x333x333x128), beside the older bar on each gradient's largest value,
and ``pytest -m cuda tests/test_torch_train_cuda.py`` runs the backward
kernel's tests.  Exits 1 if a fault escapes either.  Needs a CUDA card:

    python3 scripts/bwd_fault_check.py
"""
from __future__ import annotations

import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
KERNEL = "src/repro_torch/kernels/csrc/flash_attention_bwd.cu"
FAULTS = {
    "dk/dv pass drops the last q tile": (
        "const int n_q = T_len > q_start ? (T_len - q_start + BQ - 1) / BQ : 0;",
        "const int n_q = T_len > q_start ? (T_len - q_start - 1) / BQ : 0;"),
    "dq pass zeroes the last q tile": (
        "__floats2bfloat162_rn(acc[4 * c + 2 * i] * scale, "
        "acc[4 * c + 2 * i + 1] * scale);",
        "q0 + BQ >= T_len ? __floats2bfloat162_rn(0.f, 0.f) : "
        "__floats2bfloat162_rn(acc[4 * c + 2 * i] * scale, "
        "acc[4 * c + 2 * i + 1] * scale);"),
}
CHECK = """
import numpy as np
import torch
import chip_smoke as cs
from repro_torch.kernels import ops, ref
rng = np.random.default_rng(15)
caught = 0
for bh, t, s, d, causal, what in cs.ATTN_BWD_CASES[:2]:
    args = cs.attn_bwd_args(torch, ops, ref, rng, torch.device("cuda"), bh,
                            t, s, d, causal)
    want = cs.bwd_plain(ref, "flash_attention_bwd", args, {"causal": causal})
    got = ops.flash_attention_bwd(*args, causal=causal)
    old = ["pass" if float((g.float() - w.float()).abs().max())
           <= 2 ** -6 * float(w.float().abs().max()) + 1e-5 else "fail"
           for g, w in zip(got, want)]
    try:
        cs.check_bwd(what, "flash_attention_bwd", got, want)
        verdict = "PASSES"
    except RuntimeError as e:
        verdict, caught = f"fails: {e}", caught + 1
    print(f"  {what} {bh}x{t}x{s}x{d}: the bar on the largest value "
          f"(dq, dk, dv) {old}; the row-by-row bar {verdict}", flush=True)
# 7: both cases caught (an error exits 1)
raise SystemExit(7 if caught == 2 else 0)
"""


def main() -> None:
    escaped = 0
    for name, (old, new) in FAULTS.items():
        t0 = time.perf_counter()
        copy = Path(tempfile.mkdtemp(prefix="cim-tuner-fault-")) / "repo"
        try:
            shutil.copytree(ROOT, copy, ignore=shutil.ignore_patterns(
                "build", "*_out", ".git"))
            src = copy / KERNEL
            text = src.read_text()
            if text.count(old) != 1:
                raise SystemExit(f"fault {name!r}: its line is not in {KERNEL}")
            src.write_text(text.replace(old, new))
            # the copy reuses the tree's built kernels; the faulty one builds
            # under its own hash
            (ROOT / "build" / "repro_torch").mkdir(parents=True, exist_ok=True)
            (copy / "build").mkdir()
            (copy / "build" / "repro_torch").symlink_to(
                ROOT / "build" / "repro_torch")
            env = dict(os.environ, PYTHONPATH=f"{copy / 'src'}:{copy}")
            print(f"[fault] {name}:", flush=True)
            check = subprocess.run([sys.executable, "-c", CHECK], cwd=copy,
                                   env=env, timeout=900)
            tests = subprocess.run(
                [sys.executable, "-m", "pytest", "-q", "-m", "cuda", "-p",
                 "no:cacheprovider", "tests/test_torch_train_cuda.py", "-k",
                 "bwd_against_plain or bwd_misaligned"], cwd=copy, env=env,
                capture_output=True, text=True, timeout=900)
            summary = tests.stdout.strip().splitlines()[-1:] or ["no output"]
            print(f"  pytest -m cuda tests/test_torch_train_cuda.py (the "
                  f"backward kernel's tests): exit {tests.returncode}, "
                  f"{summary[0]}", flush=True)
            caught = check.returncode == 7 and tests.returncode == 1
            escaped += not caught
            print(f"  {'caught by both' if caught else 'ESCAPED'} in "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
        finally:
            shutil.rmtree(copy.parent, ignore_errors=True)
    sys.exit(1 if escaped else 0)


if __name__ == "__main__":
    main()
