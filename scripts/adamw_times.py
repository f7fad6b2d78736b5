#!/usr/bin/env python3
"""Time the fused optimizer's kernels alone on one CUDA card, over the leaf
tables of the benchmark's two configurations, beside their bound and the
per-leaf plain version they replace.

    python3 scripts/adamw_times.py [--archs yi-6b:16 falcon-mamba-7b:32] [--no-loop]

For each ``arch:layers`` it builds the port's trainable tree at that depth
(``chip_smoke.optimizer_leaves``: the benchmark's leaves, shapes and decay
rule), allocates p, g, m and v on the card (16 B a parameter) and times,
with ``chip_smoke.measure_optimizer_case`` (CUDA events, and from a CUDA
graph): the norm (``adamw_sumsq`` + ``adamw_norm``: three launches), the
update (``adamw_apply``: one launch), the table's build and upload on the
host, and, unless ``--no-loop``, the plain versions' norm and update
(``kernels/ref.py``, leaf by leaf: the path the kernels replace).  Bounds:
4 B (norm) and 28 B (update) a parameter over 3.35 TB/s.  At these depths
the card has no room for the plain version's copies, so the bit-equality
check is the smoke's (phase 15.a, at 2 layers).  The last line is a JSON
record of every row, with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402  (puts ROOT/src on the path)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--archs", nargs="+",
                    default=["yi-6b:16", "falcon-mamba-7b:32"])
    ap.add_argument("--no-loop", action="store_true")
    args = ap.parse_args()
    import torch

    from repro_torch.kernels import ops, ref

    if not torch.cuda.is_available():
        sys.exit("adamw_times.py needs a CUDA card")
    card = torch.device("cuda")
    rows = []
    for spec in args.archs:
        arch, layers = spec.split(":")
        r = cs.measure_optimizer_case(torch, ops, ref, arch, int(layers),
                                      card, check=False,
                                      loop=not args.no_loop)
        print(json.dumps(r), flush=True)
        rows.append(r)
    print(json.dumps({"card": cs.card_line(), "rows": rows}))


if __name__ == "__main__":
    main()
