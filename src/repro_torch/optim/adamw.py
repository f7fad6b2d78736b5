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
"""
from __future__ import annotations

import dataclasses
import math

import torch


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


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum over leaves (in order) of each leaf's fp32 sum of
    squares."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads))


class AdamW:
    def __init__(self, config: AdamWConfig = AdamWConfig()):
        self.config = config

    def init(self, params) -> dict:
        zeros = lambda: [torch.zeros(p.shape, dtype=torch.float32,
                                     device=p.device)
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
