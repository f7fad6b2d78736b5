"""The readings a training cell's limits are set from, on the card, at the
cell's own size, in one process:

- for every seed, the program's checked steps (the driver's own set-up
  and warm-up) against the plain fp32 reference: the lower readings;
- for the first ``--controls`` seeds, the control (the reference with
  its products' operands in fp8) and the program with half the batch
  left out (``faults.half_batch``), each against the same reference.

    python3 perfbench/calibrate.py --workload yi-6b.train-1x16384 \
        --seeds 11 12 13 --controls 3 --out build/calib.json

Each seed's numbers are printed as a JSON line as they come; the file
holds them all and, per number, the largest program reading and the
smallest control and fault readings.  Not part of a benchmark run.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def program_readings(cell, seed: int, device, wrap=None) -> tuple:
    """The program's readings of the checked steps for ``seed``, with its
    step wrapped by ``wrap`` (a fault) if given: (readings, stream,
    sound)."""
    import torch
    from repro_torch.data.pipeline import make_batch_iterator

    from perfbench.drivers import train

    trainer, params, opt, stream, leaves = train.build(cell, seed, device)
    if wrap is not None:
        trainer.step_fn = wrap(trainer.step_fn)
    tr = dict(cell.traffic, warmup_steps=cell.traffic["check_steps"])
    log = {"data_s": [], "step_s": [], "records": []}
    it = make_batch_iterator(stream, str(device))
    sync = (lambda: torch.cuda.synchronize(device)) \
        if device.type == "cuda" else (lambda: None)
    try:
        prog = train.warm_up(trainer, params, opt, it, leaves, seed, tr, log,
                             sync)
    finally:
        it.close()
    recs = log["records"]
    sound = not any(r["skipped"] for r in recs) and all(
        math.isfinite(r["loss"]) for r in recs)
    return prog, stream, sound


def worst_leaves(cell, prog: dict, ref: dict) -> dict:
    """The leaf that sets each per-leaf number, with its gap, and the
    leaves the change leaves out."""
    from perfbench import check, weights

    names = [leaf.name for leaf in weights.layout(cell.config)]
    out = {}
    for key in ("first_grad", "change"):
        gaps = check.leaf_gaps(prog[key], ref[key])
        if key == "change":
            gaps = [g if k else -1.0 for g, k in zip(gaps, check.kept(ref))]
        i = max(range(len(gaps)), key=gaps.__getitem__)
        out[key] = [names[i], gaps[i]]
    out["left_out"] = [n for n, k in zip(names, check.kept(ref)) if not k]
    return out


def calibrate(cell, seeds: list, controls: int, device, emit=print) -> dict:
    from perfbench import check, faults
    from perfbench.drivers.train import free_device
    from perfbench.reference import common

    tr = cell.traffic
    rows = []
    for n, seed in enumerate(seeds):
        row = {"seed": seed}
        t = time.perf_counter()
        prog, stream, sound = program_readings(cell, seed, device)
        free_device()
        row["program_s"] = time.perf_counter() - t
        batches = [stream.global_batch_at(s) for s in range(tr["check_steps"])]
        t = time.perf_counter()
        ref = common.train_steps(cell.config, tr["optimizer"], batches, seed,
                                 device, common.Precision("fp32"))
        free_device()
        row["reference_s"] = time.perf_counter() - t
        row["sound"] = sound
        row["program"] = check.numbers(prog, ref)
        row["worst"] = worst_leaves(cell, prog, ref)
        row["losses"] = {"program": prog["loss"], "reference": ref["loss"]}
        if n < controls:
            t = time.perf_counter()
            ctl = common.train_steps(cell.config, tr["optimizer"], batches,
                                     seed, device, common.Precision("fp8"))
            free_device()
            row["control_s"] = time.perf_counter() - t
            row["control"] = check.numbers(ctl, ref)
            half, _, _ = program_readings(cell, seed, device,
                                          wrap=faults.half_batch)
            free_device()
            row["half_batch"] = check.numbers(half, ref)
        emit(json.dumps(row))
        rows.append(row)
    keys = rows[0]["program"]
    pick = lambda kind, f: {k: f(r[kind][k] for r in rows if kind in r)
                            for k in keys}
    return {"workload": cell.workload, "rows": rows,
            "lower": pick("program", max), "control": pick("control", min),
            "half_batch": pick("half_batch", min)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from perfbench import harness

    cell = harness.find_cell(args.workload, ROOT)
    harness.set_cache_dirs(ROOT)
    harness.need_program(ROOT)
    harness.need_cards(cell.entry["chips"])
    import torch

    out = calibrate(cell, args.seeds, args.controls, torch.device("cuda"))
    out["device"] = torch.cuda.get_device_name(0)
    out["card"] = harness.card_sample()
    Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps({k: out[k] for k in ("lower", "control", "half_batch")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
