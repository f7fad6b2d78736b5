"""Training entry point.

    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b --smoke \
        --steps 50 --batch 8 --seq 256 --device cpu

``--smoke`` uses the family-faithful reduced config (CPU-runnable); omit it
on a card for the full architecture (with ``--set n_layers=8`` to fit its
training state on one H100).  Any ArchConfig field can be overridden with
``--set field=value``.  ``--mesh DxM`` trains on a ("data", "model")
``DeviceMesh`` (``launch.mesh.make_debug_mesh``; ``--mesh 1x1`` is one
rank, a larger mesh needs a process group of its size started by the
caller); without it the trainer runs on ``--device`` alone (the card by
default; ``cpu`` for the CPU, which also holds a ``--mesh``'s ranks).
"""
from __future__ import annotations

import argparse
import ast
import dataclasses


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default="checkpoints")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--data-file", default=None,
                    help="flat int32 token file (default: synthetic stream)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (cuda, cuda:1, cpu)")
    ap.add_argument("--mesh", default=None, metavar="DxM",
                    help="train on a (data, model) DeviceMesh of D x M ranks")
    ap.add_argument("--set", action="append", default=[],
                    help="ArchConfig override field=value")
    args = ap.parse_args()

    from repro_torch.configs import get_arch
    from repro_torch.optim import AdamWConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    for ov in args.set:
        k, v = ov.split("=", 1)
        cur = getattr(cfg, k)
        cfg = dataclasses.replace(cfg, **{k: type(cur)(v) if cur is not None
                                          else ast.literal_eval(v)})

    tcfg = TrainerConfig(
        steps=args.steps, seq_len=args.seq, global_batch=args.batch,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        optimizer=AdamWConfig(peak_lr=args.lr, warmup_steps=args.steps // 10,
                              total_steps=args.steps),
    )
    stream = None
    if args.data_file:
        from repro_torch.data.pipeline import DataConfig, TokenFileStream
        stream = TokenFileStream(
            DataConfig(seq_len=args.seq, global_batch=args.batch,
                       vocab=cfg.vocab), args.data_file)
    trainer = Trainer(cfg, tcfg, mesh_or_device(args.mesh, args.device),
                      stream=stream)
    trainer.train()
    print(f"straggler steps: {trainer.straggler_steps}")


def mesh_or_device(mesh: str | None, device: str):
    """``make_debug_mesh`` of ``--mesh DxM`` on ``--device``'s kind, or
    the device itself without ``--mesh``."""
    if mesh is None:
        return device
    import torch

    from repro_torch.launch.mesh import make_debug_mesh
    nd, nm = (int(x) for x in mesh.split("x"))
    return make_debug_mesh(nd, nm, device_type=torch.device(device).type)


if __name__ == "__main__":
    main()
