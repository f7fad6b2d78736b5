"""Step builders, the reference's ``launch/steps.py`` in PyTorch.

``make_train_step`` is the trainer's step: the loss, its gradients by
autograd (through the hand-written kernels' backward on the card), and an
in-place AdamW update; ``microbatches > 1`` accumulates fp32 gradients
over equal slices of the batch, as the reference's scan does.  The
reference's abstract input specs and jitted, sharded cell assembly
(``sds``, ``*_batch_specs``, ``input_specs``, ``build_cell``) serve its
mesh and dry-run tools and are not here.
"""
from __future__ import annotations

import torch

from repro_torch.models.model import Model
from repro_torch.optim import AdamW


def _grads(model: Model, params, leaves: list, batch: dict):
    """(loss, metrics, gradients of the loss, one per leaf; None where the
    loss does not reach a leaf)."""
    loss, metrics = model.loss(params, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), metrics, grads


def make_train_step(model: Model, optimizer: AdamW, microbatches: int = 1):
    """``train_step(params, opt_state, batch, *, skip_nonfinite=False)
    -> (params, opt_state, metrics)``; params and state are updated in
    place.  Metrics: the loss's own (``ce``, ``z_loss``, ``tokens``, and
    ``moe_aux`` for MoE), ``loss``, ``grad_norm`` and ``lr``; with
    microbatches, ``grad_norm``, ``lr``, ``loss`` (the mean over slices)
    and ``tokens`` (the batch's token count), as the reference's."""
    if microbatches == 1:
        def train_step(params, opt_state, batch, *, skip_nonfinite=False):
            leaves = list(params.parameters())
            loss, metrics, grads = _grads(model, params, leaves, batch)
            params, opt_state, stats = optimizer.update(
                grads, opt_state, params, ndims=model.reference_ndims(params),
                skip_nonfinite=skip_nonfinite)
            metrics = dict({k: v.detach() for k, v in metrics.items()},
                           loss=loss, **stats)
            return params, opt_state, metrics
        return train_step

    def train_step(params, opt_state, batch, *, skip_nonfinite=False):
        for x in batch.values():
            if x.shape[0] % microbatches:
                raise ValueError(f"global batch {x.shape[0]} not divisible "
                                 f"by {microbatches} microbatches")
        leaves = list(params.parameters())
        gsum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for p in leaves]
        loss_sum = torch.zeros((), dtype=torch.float32,
                               device=leaves[0].device)
        for mb_batch in zip(*(x.chunk(microbatches) for x in batch.values())):
            loss, _m, grads = _grads(model, params, leaves,
                                     dict(zip(batch, mb_batch)))
            for acc, g in zip(gsum, grads):
                if g is not None:
                    acc.add_(g.float())
            loss_sum = loss_sum + loss
        grads = [g / microbatches for g in gsum]
        del gsum
        params, opt_state, stats = optimizer.update(
            grads, opt_state, params, ndims=model.reference_ndims(params),
            skip_nonfinite=skip_nonfinite)
        metrics = dict(stats, loss=loss_sum / microbatches,
                       tokens=torch.tensor(float(batch["tokens"].numel())))
        return params, opt_state, metrics
    return train_step


def make_prefill_step(model: Model):
    def prefill_step(params, batch):
        return model.prefill(params, batch)
    return prefill_step


def make_decode_step(model: Model):
    def decode_step(params, caches, tokens):
        return model.decode(params, caches, tokens)
    return decode_step
