"""Step builders + abstract input specs for every (arch x shape) cell, the
reference's ``launch/steps.py`` in PyTorch.

``make_train_step`` is the trainer's step: the loss, its gradients by
autograd (through the hand-written kernels' backward on the card), and an
in-place AdamW update; ``microbatches > 1`` accumulates fp32 gradients
over equal slices of the batch, as the reference's scan does.  Each of the
three runs in an ``obs`` span (``step.forward``, ``step.backward``,
``step.optimizer``), which a running torch profiler records.

``input_specs`` returns meta-device stand-ins of the cell's inputs
(shapes and dtypes, no allocation: the twin of ``ShapeDtypeStruct``), and
``build_cell`` assembles one (arch x shape x mesh) cell: the step with its
inputs placed on a ``DeviceMesh`` by the sharding rules and its outputs
kept there (the twins of ``in_shardings`` / ``out_shardings``).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.models import sharding as sh
from repro_torch.models.model import Model, build_model
from repro_torch.obs.trace import span
from repro_torch.optim import AdamW


# ---------------------------------------------------------------------- #
# abstract inputs
# ---------------------------------------------------------------------- #
def sds(shape, dtype) -> torch.Tensor:
    """A shape-and-dtype stand-in: a meta tensor."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def train_batch_specs(cfg: ArchConfig, shape: ShapeSpec) -> dict:
    b, t = shape.global_batch, shape.seq_len
    batch = {
        "tokens": sds((b, t), torch.int32),
        "labels": sds((b, t), torch.int32),
    }
    if cfg.n_memory:
        batch["memory"] = sds((b, cfg.n_memory, cfg.d_model), torch.bfloat16)
    return batch


def prefill_batch_specs(cfg: ArchConfig, shape: ShapeSpec) -> dict:
    b, t = shape.global_batch, shape.seq_len
    batch = {"tokens": sds((b, t), torch.int32)}
    if cfg.n_memory:
        batch["memory"] = sds((b, cfg.n_memory, cfg.d_model), torch.bfloat16)
    return batch


def decode_specs(model: Model, shape: ShapeSpec) -> tuple[Any, Any]:
    """(abstract caches at seq_len occupancy, next-token spec)."""
    b = shape.global_batch
    caches = model.abstract_cache(b, shape.seq_len)
    tokens = sds((b, 1), torch.int32)
    return caches, tokens


def input_specs(cfg: ArchConfig, shape: ShapeSpec, model: Model | None = None
                ) -> dict:
    """All abstract inputs of the cell's step function, keyed by arg name."""
    model = model or build_model(cfg)
    if shape.kind == "train":
        return {"batch": train_batch_specs(cfg, shape)}
    if shape.kind == "prefill":
        return {"batch": prefill_batch_specs(cfg, shape)}
    caches, tokens = decode_specs(model, shape)
    return {"caches": caches, "tokens": tokens}


def _grads(model: Model, params, leaves: list, batch: dict):
    """(loss, metrics, gradients of the loss, one per leaf; None where the
    loss does not reach a leaf)."""
    with span("step.forward"):
        loss, metrics = model.loss(params, batch)
    with span("step.backward"):
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    # on a mesh each gradient is placed as its parameter (autograd may
    # leave it Partial), so the optimizer's in-place updates see one layout
    grads = [g if g is None or not sh.is_dtensor(g)
             or tuple(g.placements) == tuple(p.placements)
             else g.redistribute(p.device_mesh, p.placements)
             for p, g in zip(leaves, grads)]
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
            with span("step.optimizer"):
                params, opt_state, stats = optimizer.update(
                    grads, opt_state, params,
                    ndims=model.reference_ndims(params),
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
        gsum = [torch.zeros_like(p, dtype=torch.float32, requires_grad=False)
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
        with span("step.optimizer"):
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


# ---------------------------------------------------------------------- #
# sharded cell assembly (used by the dry-run report, trainer, server)
# ---------------------------------------------------------------------- #
def on_mesh(fn, mesh):
    """``fn`` run with its plain tensors taken as replicated DTensors (the
    model's masks, positions and zeros meet sharded activations).  With no
    ``DeviceMesh`` it is ``fn``."""
    from repro_torch.launch.mesh import is_mesh

    if not is_mesh(mesh):
        return fn

    def run(*args, **kw):
        from torch.distributed.tensor.experimental import implicit_replication
        with implicit_replication():
            return fn(*args, **kw)
    return run


def logits_spec(cfg: ArchConfig, b: int, t: int, mesh) -> tuple:
    dp = sh.dp_axes(mesh)
    tp = "model" if "model" in mesh.mesh_dim_names else None
    return sh._fit((dp, None, tp), (b, t, cfg.vocab), mesh)


def _placed(cfg: ArchConfig, logits, caches, mesh) -> tuple:
    """Prefill / decode outputs on the mesh: logits and caches by their
    rules."""
    b, t = logits.shape[:2]
    return (sh.place(logits, logits_spec(cfg, b, t, mesh), mesh),
            sh.distribute(caches, sh.cache_shardings(cfg, caches, mesh),
                          mesh))


def _need_mesh(mesh) -> None:
    from repro_torch.launch.mesh import is_mesh

    if not is_mesh(mesh):
        raise TypeError(f"{mesh!r} places nothing: build the cell on a "
                        f"DeviceMesh (launch.mesh.make_debug_mesh) to run it")


def build_cell(cfg: ArchConfig, shape: ShapeSpec, mesh, *,
               optimizer: AdamW | None = None, sp_seq: bool = False,
               microbatches: int = 1):
    """Returns (step_fn, abstract_args) for one (arch x shape x mesh).

    ``abstract_args`` are meta tensors (train: the fp32 parameters, the
    AdamW state, the batch; prefill: the parameters as served, the batch;
    decode: the parameters, the caches at ``seq_len``, the next tokens).
    ``step_fn`` takes real ones (plain tensors, the same full values on
    every rank, or DTensors), places them on the ``DeviceMesh`` ``mesh``
    by the sharding rules, runs the step, and returns its outputs placed
    by the rules too: train (params, opt_state, metrics) with the metrics
    as full tensors, updated in place; prefill and decode (logits,
    caches).  An ``AbstractMesh`` gives the abstract arguments; its step
    raises."""
    shard_act = sh.make_shard_act(mesh, sp_seq=sp_seq)
    model = build_model(cfg, shard_act=shard_act)
    train = shape.kind == "train"
    a_params = model.abstract_params(trainable=train)
    p_sh = sh.param_shardings(cfg, a_params, mesh)

    if train:
        optimizer = optimizer or AdamW()
        a_opt = optimizer.init(a_params)
        o_sh = sh.opt_shardings(cfg, a_params, mesh)
        batch = train_batch_specs(cfg, shape)
        step = on_mesh(make_train_step(model, optimizer,
                                       microbatches=microbatches), mesh)

        def train_cell(params, opt_state, batch, **kw):
            _need_mesh(mesh)
            params = sh.distribute(params, p_sh, mesh)
            opt_state = sh.distribute(opt_state, o_sh, mesh)
            batch = sh.distribute(batch, sh.batch_shardings(batch, mesh),
                                  mesh)
            params, opt_state, metrics = step(params, opt_state, batch, **kw)
            return (sh.distribute(params, p_sh, mesh),
                    sh.distribute(opt_state, o_sh, mesh), sh.gather(metrics))
        train_cell.model = model
        return train_cell, (a_params, a_opt, batch)

    if shape.kind == "prefill":
        batch = prefill_batch_specs(cfg, shape)
        step = on_mesh(make_prefill_step(model), mesh)

        def prefill_cell(params, batch):
            _need_mesh(mesh)
            params = sh.distribute(params, p_sh, mesh)
            batch = sh.distribute(batch, sh.batch_shardings(batch, mesh),
                                  mesh)
            return _placed(cfg, *step(params, batch), mesh)
        prefill_cell.model = model
        return prefill_cell, (a_params, batch)

    a_cache, tokens = decode_specs(model, shape)
    step = on_mesh(make_decode_step(model), mesh)

    def decode_cell(params, caches, tokens):
        _need_mesh(mesh)
        params = sh.distribute(params, p_sh, mesh)
        caches = sh.distribute(caches, sh.cache_shardings(cfg, caches, mesh),
                               mesh)
        tokens = sh.place(tokens, sh.batch_rule("tokens", tuple(tokens.shape),
                                                mesh), mesh)
        return _placed(cfg, *step(params, caches, tokens), mesh)
    decode_cell.model = model
    return decode_cell, (a_params, a_cache, tokens)
