"""AdamW with warmup+cosine schedule and global-norm clipping, the
reference's ``optim/adamw.py`` in PyTorch.

The state holds fp32 moments ``m`` and ``v``, one per parameter in the
order of ``params.parameters()`` (a ``ParamTree`` or any module), and the
step count.  ``update`` changes the parameters and moments in place, one
leaf at a time (so the transient memory is one leaf's, not the model's),
and keeps the reference's arithmetic: the step
counts from 1, the clip and the update run in fp32, bias correction, no
decay on leaves of fewer than 2 dims -- counted in the reference's pytree
when the caller passes ``ndims`` (``Model.reference_ndims``: the
reference stacks the layers of its scanned groups [G, ...], so their
norms and biases have 2 dims there and are decayed).  The schedule, the
norm and the clip scale stay on the parameters' device as 0-dim fp32
tensors; only ``skip_nonfinite`` reads the norm on the host.

DTensor parameters (a ``DeviceMesh`` cell) are updated on their local
shards: the update is elementwise, so each rank's shard of the parameter,
its gradient and its moments -- placed alike -- is updated as a plain
tensor, with no DTensor dispatch.  Only the norm crosses ranks: a leaf's
local sum of squares is added over the mesh dims that shard it.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist


def cosine_schedule(step, *, peak_lr: float, warmup: int, total: int,
                    floor_frac: float = 0.1) -> torch.Tensor:
    """The learning rate at ``step`` (an int or a tensor), fp32, in the
    reference's order of operations."""
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = peak_lr * step / max(1.0, warmup)
    prog = torch.clamp((step - warmup) / max(1.0, total - warmup), 0, 1)
    cos = peak_lr * (floor_frac + (1 - floor_frac) * 0.5 *
                     (1 + torch.cos(math.pi * prog)))
    return torch.where(step < warmup, warm, cos)


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _shard_dims(x) -> tuple[int, ...]:
    """The mesh dims that shard a DTensor (none for a plain tensor)."""
    if not _is_dtensor(x):
        return ()
    if any(p.is_partial() for p in x.placements):
        raise ValueError(f"a gradient with pending sums {x.placements}: "
                         f"place it as its parameter first")
    return tuple(i for i, p in enumerate(x.placements) if p.is_shard())


def _local(x: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (an alias under no_grad), a plain tensor as
    it is."""
    return x.to_local() if _is_dtensor(x) else x


def leaf_sumsq(grads) -> list[torch.Tensor]:
    """Each leaf's fp32 sum of squares; for a DTensor leaf its shards'
    local sums added over the mesh dims that shard it (one all-reduce per
    such set of dims for all the leaves that share it)."""
    sums = [torch.sum(torch.square(_local(g).float())) for g in grads]
    groups: dict = {}
    for i, g in enumerate(grads):
        dims = _shard_dims(g)
        if dims:
            groups.setdefault((g.device_mesh, dims), []).append(i)
    for (mesh, dims), idx in groups.items():
        vec = torch.stack([sums[i] for i in idx])
        for d in dims:
            dist.all_reduce(vec, group=mesh.get_group(d))
        for j, i in enumerate(idx):
            sums[i] = vec[j]
    return sums


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum over leaves (in order) of each leaf's fp32 sum of
    squares."""
    return torch.sqrt(sum(leaf_sumsq(grads)))


def _locals(p, *others) -> tuple:
    """``p`` and the tensors updated with it as their local shards; a
    DTensor ``p`` needs each of them placed as it is."""
    if not _is_dtensor(p):
        return (p, *others)
    for x in others:
        if not _is_dtensor(x) or tuple(x.placements) != tuple(p.placements):
            raise ValueError(
                f"a parameter placed {tuple(p.placements)} is updated with "
                f"{tuple(x.placements) if _is_dtensor(x) else 'a plain tensor'}"
                f": place its gradient and moments as the parameter")
    return tuple(x.to_local() for x in (p, *others))


class AdamW:
    def __init__(self, config: AdamWConfig = AdamWConfig()):
        self.config = config

    def init(self, params) -> dict:
        """Zero moments shaped (and, for DTensor parameters, placed) as
        the parameters."""
        zeros = lambda: [torch.zeros_like(p, dtype=torch.float32,
                                          requires_grad=False)
                         for p in params.parameters()]
        return {"m": zeros(), "v": zeros(), "step": 0}

    @torch.no_grad()
    def update(self, grads, state: dict, params, *, ndims=None,
               skip_nonfinite: bool = False) -> tuple:
        """Returns (params, state, stats), both updated in place.
        ``grads`` lists one gradient per parameter (None counts as zeros);
        ``ndims`` each leaf's dims for the decay rule (default its own).
        With ``skip_nonfinite``, a non-finite gradient norm changes
        nothing and ``stats["skipped"]`` is True."""
        c = self.config
        leaves = list(params.parameters())
        ndims = ndims or [p.dim() for p in leaves]
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        dev = leaves[0].device
        step = state["step"] + 1
        lr = cosine_schedule(step, peak_lr=c.peak_lr, warmup=c.warmup_steps,
                             total=c.total_steps).to(dev)
        gnorm = global_norm(grads)
        stats = {"grad_norm": gnorm, "lr": lr}
        if skip_nonfinite:
            stats["skipped"] = not math.isfinite(float(gnorm))
            if stats["skipped"]:
                return params, state, stats
        scale = torch.clamp(c.grad_clip / torch.clamp(gnorm, min=1e-12),
                            max=1.0)
        f32 = lambda x: torch.tensor(x, dtype=torch.float32)
        b1c = (1.0 - f32(c.b1) ** f32(step)).to(dev)
        b2c = (1.0 - f32(c.b2) ** f32(step)).to(dev)
        for p, g, m, v, nd in zip(leaves, grads, state["m"], state["v"],
                                  ndims):
            p, g, m, v = _locals(p, g, m, v)
            g = g.float() * scale
            # the reference's order: b1 m + ((1 - b1) g), b2 v + ((1 - b2) g) g
            m.mul_(c.b1).add_(g * (1 - c.b1))
            v.mul_(c.b2).add_((g * (1 - c.b2)).mul_(g))
            upd = (m / b1c).div_(torch.sqrt(v / b2c).add_(c.eps))
            if nd >= 2:                    # no decay on norms / biases
                upd.add_(c.weight_decay * p.float())
            p.copy_(p.float() - lr * upd)
            del g, upd
        state["step"] = step
        return params, state, stats
