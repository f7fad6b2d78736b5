"""Faults planted under a training cell's timed path, to show that the
check refuses them: each wraps the trainer's ``step_fn``.

- :func:`half_batch`: the second half of the batch's tokens left out and
  the loss's mean taken over the rest (their labels masked, -1);
- :func:`unchanged`: a step that returns its parameters and optimizer
  state as they were (it keeps a copy of them, so at small sizes only).
"""
from __future__ import annotations

import torch


def half_batch(step_fn):
    def step(params, opt, batch):
        labels = batch["labels"].clone()
        flat = labels.view(-1)
        flat[flat.numel() // 2:] = -1
        return step_fn(params, opt, dict(batch, labels=labels))
    return step


def unchanged(step_fn):
    def step(params, opt, batch):
        with torch.no_grad():
            before = [p.detach().clone() for p in params.parameters()]
            moments = {k: [x.clone() for x in opt[k]] for k in ("m", "v")}
            count = opt["step"]
        params, opt, metrics = step_fn(params, opt, batch)
        with torch.no_grad():
            for p, b in zip(params.parameters(), before):
                p.copy_(b)
            for k, xs in moments.items():
                for x, b in zip(opt[k], xs):
                    x.copy_(b)
            opt["step"] = count
        return params, opt, metrics
    return step
