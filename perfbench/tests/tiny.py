"""Cells of the benchmark's configurations cut to a CPU test's size (every
width small, the kinds of layers and the traffic's shape kept)."""
from __future__ import annotations

import json
from pathlib import Path

from perfbench import harness

ROOT = Path(__file__).resolve().parents[2]
SIZES = {
    "yi-6b": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                  head_dim=16, d_ff=128, vocab=512),
    "falcon-mamba-7b": dict(n_layers=2, d_model=64, d_inner=128, ssm_state=8,
                            dt_rank=8, vocab=512),
}
#: (configuration, traffic, tokens a row, rows) of each cell, cut
CELLS = {
    "yi-6b.train-1x16384": ("yi-6b", "train-1x16384", 128, 1),
    "falcon-mamba-7b.train-2x4096": ("falcon-mamba-7b", "train-2x4096", 64, 2),
}


def cell(workload: str) -> harness.Cell:
    """``workload`` at a test's size, with its committed limits."""
    config, traffic, seq, rows = CELLS[workload]
    bench = ROOT / "perfbench"
    cfg = json.loads((bench / "configs" / f"{config}.json").read_text())
    cfg.update(SIZES[config])
    tr = json.loads((bench / "traffic" / f"{traffic}.json").read_text())
    tr.update(seq_len=seq, batch=rows)
    return harness.Cell(workload=workload, entry={"chips": 1}, config=cfg,
                        traffic=tr,
                        limits_path=bench / "limits" / f"{workload}.json",
                        end_to_end=[], per_layer=[], root=ROOT)
