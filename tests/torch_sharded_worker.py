"""One rank of the sharded-cell runs of ``tests/test_torch_sharded_step.py``.

    python tests/torch_sharded_worker.py RANK WORLD STORE OUT

joins a gloo group of WORLD processes through the ``FileStore`` at STORE,
builds a 2x2 ("data", "model") mesh on the CPU and runs, through
``launch.steps.build_cell``: a train cell of reduced yi-6b and of reduced
falcon-mamba-7b for ``STEPS`` steps, one step of reduced yi-6b under each
of ``VARIANT_CELLS``, both train cells again with every product in fp32
(``fp32_compute``) on the 2x2 mesh and on a 4x1 one (data parallel: every
weight replicated, each layer one ``local_map`` region), a prefill cell
and a decode cell of reduced yi-6b,
then ``compressed_allreduce`` over the group.  Rank 0
writes every result, as full tensors, to OUT (``torch.save``).  The inputs
come from the functions below, which the test calls for its one-process
runs.
"""
from __future__ import annotations

import contextlib
import os
import sys

import numpy as np
import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.configs import ShapeSpec, get_arch  # noqa: E402
from repro_torch.optim import AdamW, AdamWConfig  # noqa: E402

TRAIN_ARCHS = ("yi-6b", "falcon-mamba-7b")
#: one step of reduced yi-6b's train cell under the variants that read the
#: mesh: FSDP over "data", and context-parallel attention
VARIANT_CELLS = {"fsdp": {"fsdp": True},
                 "seq_shard_attn": {"seq_shard_attn": True,
                                    "shard_attn": False}}
SERVE_ARCH = "yi-6b"
BATCH, SEQ, STEPS = 4, 32, 2
OPT = AdamWConfig(peak_lr=1e-3, warmup_steps=1, total_steps=10)
#: the leaves of the int8 all-reduce: ragged sizes (padding to a block)
GRAD_SHAPES = ((300,), (17, 33), (256,), (3, 5, 7))


@contextlib.contextmanager
def fp32_compute():
    """The models' products in fp32 (``COMPUTE_DTYPE``, read by name in
    each model module): no bf16 rounding is left to hide a wrong placement
    or a lost sum, so the sharded cell must equal one process up to the
    order of fp32 sums."""
    import importlib

    import torch
    mods = [importlib.import_module(f"repro_torch.models.{m}")
            for m in ("layers", "transformer", "model", "moe", "ssm")]
    saved = [m.COMPUTE_DTYPE for m in mods]
    for m in mods:
        m.COMPUTE_DTYPE = torch.float32
    try:
        yield
    finally:
        for m, dt in zip(mods, saved):
            m.COMPUTE_DTYPE = dt


def config(arch: str, **overrides):
    import dataclasses
    return dataclasses.replace(get_arch(arch).reduced(), **overrides)


def train_batch(cfg, step: int) -> dict:
    rng = np.random.default_rng((7, step))
    toks = rng.integers(0, cfg.vocab, (BATCH, SEQ + 1))
    return {"tokens": torch.as_tensor(toks[:, :-1], dtype=torch.int32),
            "labels": torch.as_tensor(toks[:, 1:], dtype=torch.int32)}


def decode_tokens(cfg) -> torch.Tensor:
    rng = np.random.default_rng(9)
    return torch.as_tensor(rng.integers(0, cfg.vocab, (BATCH, 1)),
                           dtype=torch.int32)


def rank_grads(rank: int) -> list[np.ndarray]:
    rng = np.random.default_rng((11, rank))
    return [rng.standard_normal(s).astype(np.float32) for s in GRAD_SHAPES]


def rank_errors(rank: int) -> list[np.ndarray]:
    rng = np.random.default_rng((13, rank))
    return [(0.01 * rng.standard_normal(s)).astype(np.float32)
            for s in GRAD_SHAPES]


def train_run(cell_or_step, model, cfg, place=lambda p: p,
              steps: int = STEPS) -> dict:
    """``steps`` steps of a train step from the seed-0 weights: the
    losses and the final parameters."""
    params = model.init(0, "cpu", trainable=True)
    opt = AdamW(OPT).init(params)
    losses = []
    for step in range(steps):
        params, opt, metrics = cell_or_step(params, opt, train_batch(cfg,
                                                                     step))
        losses.append(float(metrics["loss"]))
    return {"losses": losses,
            "params": {n: place(p).detach().clone()
                       for n, p in params.named_parameters()},
            "placements": {n: str(tuple(getattr(p, "placements", ())))
                           for n, p in params.named_parameters()}}


def main(rank: int, world: int, store: str, out: str) -> None:
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.steps import build_cell
    from repro_torch.optim.compression import compressed_allreduce, quantize_int8

    torch.manual_seed(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        mesh = make_debug_mesh(2, 2, device_type="cpu")
        full = lambda t: t.full_tensor()
        res: dict = {}
        for arch in TRAIN_ARCHS:
            cfg = config(arch)
            cell, _ = build_cell(cfg, ShapeSpec("train", SEQ, BATCH, "train"),
                                 mesh, optimizer=AdamW(OPT))
            res[arch] = train_run(cell, cell.model, cfg, full)
        for tag, ov in VARIANT_CELLS.items():
            cfg = config("yi-6b", **ov)
            cell, _ = build_cell(cfg, ShapeSpec("train", SEQ, BATCH, "train"),
                                 mesh, optimizer=AdamW(OPT))
            res[tag] = train_run(cell, cell.model, cfg, full, steps=1)
        dp = make_debug_mesh(4, 1, device_type="cpu")
        with fp32_compute():
            for arch in TRAIN_ARCHS:
                cfg = config(arch)
                for tag, m in (("2x2", mesh), ("4x1", dp)):
                    cell, _ = build_cell(cfg, ShapeSpec("train", SEQ, BATCH,
                                                        "train"),
                                         m, optimizer=AdamW(OPT))
                    res[f"{arch}/fp32/{tag}"] = train_run(cell, cell.model,
                                                          cfg, full)

        cfg = config(SERVE_ARCH)
        prefill, _ = build_cell(cfg, ShapeSpec("p", SEQ, BATCH, "prefill"),
                                mesh)
        decode, _ = build_cell(cfg, ShapeSpec("d", SEQ, BATCH, "decode"),
                               mesh)
        params = prefill.model.init(0, "cpu")
        logits, caches = prefill(params, {"tokens": train_batch(cfg, 0)[
            "tokens"]})
        res["prefill"] = {"logits": full(logits),
                          "placement": str(tuple(logits.placements)),
                          "k0": full(caches["stack"][0]["k"]),
                          "k0_placement": str(tuple(
                              caches["stack"][0]["k"].placements))}
        logits, caches = decode(params, caches, decode_tokens(cfg))
        res["decode"] = {"logits": full(logits),
                         "k0": full(caches["stack"][0]["k"]),
                         "step": caches["step"]}

        grads = [torch.as_tensor(g) for g in rank_grads(rank)]
        errors = [torch.as_tensor(e) for e in rank_errors(rank)]
        mean, new_err = compressed_allreduce(grads, errors=errors)
        sums = []
        for g, e in zip(grads, errors):
            q, _ = quantize_int8(g.float() + e)
            q = q.to(torch.int32)
            dist.all_reduce(q)
            sums.append(q)
        res["allreduce"] = {"mean": mean, "errors": new_err, "sums": sums}
        if rank == 0:
            torch.save(res, out)
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
