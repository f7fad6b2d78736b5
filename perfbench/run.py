"""One run of one benchmark cell on the card.

    python3 perfbench/run.py --workload yi-6b.train-1x16384 --seed 7 \
        --seconds 30 --trace 0

Prints the cell's end-to-end metrics (``--trace 0``) or its per-layer
metrics (``--trace 1``) as the last line of standard output, one JSON
object, after a line with the run's noise record; the numbers of the
correctness check go to standard error as its last lines.  Exits non-zero
with no result where there is no card, where the port is missing, or
where the run loaded JAX or the JAX package.
"""
from __future__ import annotations

import os
import sys
import time
from pathlib import Path


def process_start() -> float:
    """The wall time at which this process started (Linux), else now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


T_START = process_start()


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    from perfbench import harness
    return harness.main(args, T_START, root)


if __name__ == "__main__":
    sys.exit(main())
