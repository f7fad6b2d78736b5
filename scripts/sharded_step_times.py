#!/usr/bin/env python3
"""Time one tree's training step with and without a mesh on one CUDA card:
the unsharded step (``make_train_step``) against ``build_cell``'s step on a
1x1 ``DeviceMesh``, from the same seed, so that the host cost of DTensor
dispatch shows beside the device time.

    python3 scripts/sharded_step_times.py [--arch yi-6b] [--depth 8]
        [--seq 4096] [--steps 10] [--narrow]

Each step is timed from its call to the end of the card's work
(``step_s``), and from its call to its return (``host_s``: the host's own
work, while the card runs behind it).  ``--narrow`` cuts every width to a
few units, so that the card's work is negligible and ``step_s`` is the
host's cost of the step.  It also counts the ops dispatched on DTensors
in one step (a dispatch mode over one extra step).  To time another
commit, unpack it (``git archive <commit> | tar -x -C build/other``),
copy this script into that tree's ``scripts/`` and run it there; run the
two trees in turns (A, B, B, A) on one card and compare only within that
session.  The last line is a JSON record.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))


def dtensor_ops(torch, fn) -> int:
    """The ops that one call of ``fn`` dispatches with a DTensor argument."""
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    n = [0]

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if any(isinstance(a, DTensor) for a in tree_leaves((args, kwargs))):
                n[0] += 1
            return func(*args, **kwargs)

    with Count():
        fn()
    return n[0]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--depth", type=int, default=8)
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--narrow", action="store_true")
    args = ap.parse_args()

    import torch

    from repro_torch.configs import SHAPES, get_arch
    from repro_torch.data.pipeline import DataConfig, SyntheticLMStream
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.steps import build_cell, make_train_step
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW, AdamWConfig

    if not torch.cuda.is_available():
        raise SystemExit("sharded_step_times: no CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_arch(args.arch), n_layers=args.depth)
    if args.narrow:
        cfg = dataclasses.replace(cfg, d_model=64, n_heads=4, n_kv_heads=1,
                                  head_dim=16, d_ff=128, vocab=256)
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=args.seq,
                                global_batch=1)
    opt_cfg = AdamWConfig(peak_lr=3e-4, warmup_steps=2, total_steps=100)
    stream = SyntheticLMStream(DataConfig(seq_len=args.seq, global_batch=1,
                                          vocab=cfg.vocab, seed=0))
    mesh = make_debug_mesh(1, 1, device_type="cuda")
    cell, _ = build_cell(cfg, shape, mesh, optimizer=AdamW(opt_cfg))
    rec = {"arch": args.arch, "depth": args.depth, "seq": args.seq,
           "narrow": args.narrow, "tree": str(ROOT), "card": card}
    for name, model, step in (
            ("unsharded", build_model(cfg),
             make_train_step(build_model(cfg), AdamW(opt_cfg))),
            ("sharded", cell.model, cell)):
        torch.cuda.empty_cache()
        params = model.init(0, dev, trainable=True)
        opt = AdamW(opt_cfg).init(params)
        batches = [{k: torch.as_tensor(v).to(dev)
                    for k, v in stream.global_batch_at(i).items()}
                   for i in range(args.steps + 1)]
        step_s, host_s, losses = [], [], []
        for i in range(args.steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, metrics = step(params, opt, batches[i])
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            host_s.append(t1 - t0)
            losses.append(float(metrics["loss"]))
        ops = dtensor_ops(torch, lambda: step(params, opt,
                                              batches[args.steps]))
        w = args.warmup
        rec[name] = dict(step_s=statistics.median(step_s[w:]),
                         step_s_min=min(step_s[w:]),
                         host_s=statistics.median(host_s[w:]),
                         step_s_all=step_s, host_s_all=host_s,
                         dtensor_ops_a_step=ops, losses=losses)
        print(f"[steps] {name}: step {rec[name]['step_s']:.4f} s (fastest "
              f"{rec[name]['step_s_min']:.4f}), host {rec[name]['host_s']:.4f}"
              f" s, {ops} DTensor ops a step; {card}", flush=True)
        del params, opt, batches, metrics
    print(json.dumps(rec))


if __name__ == "__main__":
    main()
