"""Fault-tolerant checkpointing, the reference's ``train/checkpoint.py``
in PyTorch, with its guarantees:

  * atomic: a step directory is written under ``step_N.tmp`` and renamed
    only after every leaf + manifest landed -- a crash mid-write can never
    corrupt the latest checkpoint;
  * self-describing: ``manifest.json`` carries step, leaf keys, shapes and
    dtypes, checked against the tree to restore before any tensor is
    touched;
  * bounded retention: ``keep`` newest checkpoints are retained.

Leaves are keyed by their path in the saved tree, with a module's
state-dict names inside it (``params/stack.layers.0.attn.wq``,
``opt/m/3``, ``opt/step``), and stored as ``.npy`` files: bf16 tensors as
their int16 bit pattern, the dtype in the manifest.  The manifest names
the port (``"format": "repro_torch"``); a checkpoint the reference wrote
(its leaves are keyed by its own pytree paths, in its own layout) is
refused with a message that says so.

DTensor leaves (a tree on a ``DeviceMesh``) are saved as their full
values, gathered on every rank and written by rank 0; a restore places
each full value by the placements of the tree it restores into, so a
checkpoint moves between meshes of any shape and to and from one device.
"""
from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from repro_torch.models import sharding as sh

FORMAT = "repro_torch"
_BITS = {torch.bfloat16: torch.int16}


def _flatten(tree, prefix: str = "") -> dict:
    """{key: leaf} of a tree of modules, dicts, lists and tensors / ints."""
    if isinstance(tree, nn.Module):
        return {prefix + k: v for k, v in tree.state_dict().items()}
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: tree}


def _spec(leaf) -> tuple[list, str]:
    if isinstance(leaf, torch.Tensor):
        return list(leaf.shape), str(leaf.dtype).removeprefix("torch.")
    return [], "int"


def _to_numpy(leaf) -> np.ndarray:
    if not isinstance(leaf, torch.Tensor):
        return np.asarray(int(leaf), np.int64)
    t = leaf.detach().cpu()
    if t.dtype in _BITS:
        t = t.view(_BITS[t.dtype])
    return t.numpy()


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------ #
    def save(self, step: int, tree) -> str:
        # every rank gathers (a collective), rank 0 writes, all wait for it
        flat = {k: v.full_tensor() if sh.is_dtensor(v) else v
                for k, v in _flatten(tree).items()}
        final = os.path.join(self.dir, f"step_{step:09d}")
        many = dist.is_available() and dist.is_initialized() and \
            dist.get_world_size() > 1
        if many and dist.get_rank() != 0:
            dist.barrier()
            return final
        try:
            self._write(step, flat, final)
        finally:
            if many:
                dist.barrier()
        return final

    def _write(self, step: int, flat: dict, final: str) -> None:
        tmp = os.path.join(self.dir, f"step_{step:09d}.tmp")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"format": FORMAT, "step": step, "leaves": {}}
        for n, (key, leaf) in enumerate(flat.items()):
            fname = f"{n:05d}.npy"
            np.save(os.path.join(tmp, fname), _to_numpy(leaf))
            shape, dtype = _spec(leaf)
            manifest["leaves"][key] = {"file": fname, "shape": shape,
                                       "dtype": dtype}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        self._gc()

    # ------------------------------------------------------------------ #
    def latest_step(self) -> int | None:
        steps = self._steps()
        return steps[-1] if steps else None

    def restore(self, tree_like, step: int | None = None):
        """Restore into ``tree_like`` (modules, dicts, lists, tensors and
        ints): returns (tree, step), the tree of the same structure with
        every tensor of ``tree_like`` (a module's state included) loaded
        in place -- no second copy of the model is held -- and every int
        replaced; a DTensor leaf takes its own part of the full value, by
        its placements.  Nothing is loaded unless every leaf's key, shape
        and dtype agree with the manifest."""
        steps = self._steps()
        if not steps:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        step = steps[-1] if step is None else step
        d = os.path.join(self.dir, f"step_{step:09d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        if manifest.get("format") != FORMAT:
            raise ValueError(
                f"{d} was not written by repro_torch: its manifest names no "
                f"port format (the reference package, repro.train.checkpoint, "
                f"writes such checkpoints, keyed by its own pytree paths); "
                f"the port cannot restore it")

        flat_like = _flatten(tree_like)
        missing = set(flat_like) - set(manifest["leaves"])
        if missing:
            raise ValueError(
                f"checkpoint missing leaves: {sorted(missing)[:5]}")
        for key, like in flat_like.items():
            meta = manifest["leaves"][key]
            shape, dtype = _spec(like)
            if shape != meta["shape"]:
                raise ValueError(
                    f"shape mismatch for {key}: ckpt {meta['shape']} "
                    f"vs expected {shape}")
            if dtype != meta["dtype"]:
                raise ValueError(
                    f"dtype mismatch for {key}: ckpt {meta['dtype']} "
                    f"vs expected {dtype}")

        @torch.no_grad()
        def load(key, like):
            arr = np.load(os.path.join(d, manifest["leaves"][key]["file"]))
            if not isinstance(like, torch.Tensor):
                return int(arr)
            t = torch.from_numpy(arr)
            if like.dtype in _BITS:
                t = t.view(like.dtype)
            if sh.is_dtensor(like):
                mesh = like.device_mesh
                t = sh.distribute_tensor_local(t.to(mesh.device_type), mesh,
                                               tuple(like.placements))
            return like.copy_(t)

        def build(like, prefix):
            if isinstance(like, nn.Module):
                for k, v in like.state_dict().items():
                    load(prefix + k, v)
                return like
            if isinstance(like, dict):
                return {k: build(v, f"{prefix}{k}/") for k, v in like.items()}
            if isinstance(like, (list, tuple)):
                return type(like)(build(v, f"{prefix}{i}/")
                                  for i, v in enumerate(like))
            return load(prefix[:-1], like)
        return build(tree_like, ""), step

    # ------------------------------------------------------------------ #
    def _steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def _gc(self) -> None:
        steps = self._steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:09d}"),
                          ignore_errors=True)
