"""AdamW with warmup+cosine schedule and global-norm clipping, the
reference's ``optim/adamw.py`` in PyTorch.

The state holds fp32 moments ``m`` and ``v``, one per parameter in the
order of ``params.parameters()`` (a ``ParamTree`` or any module), and the
step count.  ``update`` changes the parameters and moments in place and
keeps the reference's arithmetic: the step
counts from 1, the clip and the update run in fp32, bias correction, no
decay on leaves of fewer than 2 dims -- counted in the reference's pytree
when the caller passes ``ndims`` (``Model.reference_ndims``: the
reference stacks the layers of its scanned groups [G, ...], so their
norms and biases have 2 dims there and are decayed).  The lr and the bias
corrections are fp32 numbers made on the host; the norm and the clip
scale stay on the parameters' device; only ``skip_nonfinite`` reads the
norm on the host.  ``update`` runs its phases in ``obs`` spans:
``optim.schedule`` (the lr and the bias corrections), ``optim.norm``,
``optim.guard`` (that read) and ``optim.apply``.

The step's leaves go into one table (``kernels.ops.adamw_table``), and
the norm and the update run through ``kernels.ops``: on the card the
hand-written multi-tensor kernels of ``kernels/csrc/adamw.cu`` take every
leaf at once, the norm in three launches and the update in one, reading
g, p, m and v once and writing p, m and v once; on the CPU their plain
versions (``kernels/ref.py``) take it leaf by leaf, with the same fp32
operations in the same order (bit-equal given the same norm).

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

from repro_torch.kernels import ops
from repro_torch.obs.trace import span


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


def _on(idx: list, device) -> torch.Tensor:
    """Leaf indices as a tensor on ``device``, through pinned memory on the
    card (no synchronous copy)."""
    at = torch.tensor(idx, dtype=torch.long)
    if device.type == "cuda":
        return at.pin_memory().to(device, non_blocking=True)
    return at


def leaf_sumsq(grads, table=None) -> torch.Tensor:
    """Each leaf's fp32 sum of squares, one a leaf in a 1-D tensor (the
    ``adamw_sumsq`` kernels over ``table`` on the card, or over a table of
    the gradients); for a DTensor leaf its shards' local sums added over
    the mesh dims that shard it (one all-reduce per such set of dims for
    all the leaves that share it)."""
    if table is None:
        table = ops.adamw_table([_local(g) for g in grads])
    sums = ops.adamw_sumsq(table)
    groups: dict = {}
    for i, g in enumerate(grads):
        dims = _shard_dims(g)
        if dims:
            groups.setdefault((g.device_mesh, dims), []).append(i)
    for (mesh, dims), idx in groups.items():
        at = _on(idx, sums.device)
        vec = sums.index_select(0, at)
        for d in dims:
            dist.all_reduce(vec, group=mesh.get_group(d))
        sums.index_copy_(0, at, vec)
    return sums


def global_norm(grads, table=None) -> torch.Tensor:
    """sqrt of the sum over leaves (in order) of each leaf's fp32 sum of
    squares, on the leaves' device."""
    return ops.adamw_norm(leaf_sumsq(grads, table))


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
        nothing and ``stats["skipped"]`` is True.  ``stats["lr"]`` is a
        0-dim fp32 tensor on the host."""
        c = self.config
        leaves = list(params.parameters())
        ndims = ndims or [p.dim() for p in leaves]
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        step = state["step"] + 1
        with span("optim.schedule"):
            lr = cosine_schedule(step, peak_lr=c.peak_lr,
                                 warmup=c.warmup_steps, total=c.total_steps)
            f32 = lambda x: torch.tensor(x, dtype=torch.float32)
            b1c = 1.0 - f32(c.b1) ** f32(step)
            b2c = 1.0 - f32(c.b2) ** f32(step)
        with span("optim.norm"):
            p_, g_, m_, v_ = zip(*(_locals(*x) for x in zip(
                leaves, grads, state["m"], state["v"])))
            table = ops.adamw_table(g_, p_, m_, v_,
                                    [nd >= 2 for nd in ndims])
            gnorm = global_norm(grads, table)
        stats = {"grad_norm": gnorm, "lr": lr}
        if skip_nonfinite:
            with span("optim.guard"):
                stats["skipped"] = not math.isfinite(float(gnorm))
            if stats["skipped"]:
                return params, state, stats
        with span("optim.apply"):
            ops.adamw_apply(table, gnorm, lr=lr, b1c=b1c, b2c=b2c, b1=c.b1,
                            b2=c.b2, eps=c.eps, weight_decay=c.weight_decay,
                            grad_clip=c.grad_clip)
        state["step"] = step
        return params, state, stats
