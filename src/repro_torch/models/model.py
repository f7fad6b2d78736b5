"""Uniform model factory: ArchConfig -> (init, loss, prefill, decode, caches),
the reference's ``models/model.py`` in PyTorch.

``build_model`` takes the model's prefill attention and Mamba scan the way
``ExplorationEngine`` takes ``evaluator=``: the defaults
(``layers.flash_prefill``, ``ssm.kernel_scan``) launch the hand-written
``flash_attention`` and ``selective_scan`` kernels on the card and run the
reference's branches on the CPU; passing the plain twins
(``layers.attention_any``, ``ssm.plain_scan``) runs the same model without
the kernels.  Two models built from one config share their parameters.
``shard_act`` is the activation sharding hook (``sharding.make_shard_act``
of a mesh; the identity by default), placed where the reference places
it.  ``abstract_params`` / ``abstract_cache`` are the reference's
``eval_shape`` twins: meta-device tensors of the right shapes and dtypes,
with no draw and no allocation.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import ssm as ssm_lib
from repro_torch.models import transformer as tf
from repro_torch.models.layers import COMPUTE_DTYPE, ShapeOnly, flash_prefill
from repro_torch.models.sharding import Identity, is_dtensor
from repro_torch.obs.trace import span


class Model:
    """The functions of one architecture over its parameters (a
    :class:`~repro_torch.models.transformer.ParamTree`).  ``loss`` is
    differentiable (the reference's, for ``jax.value_and_grad``);
    ``prefill`` and ``decode`` run under ``torch.inference_mode`` (under
    ``no_grad`` on a mesh)."""

    def __init__(self, cfg: ArchConfig, *, attention=flash_prefill,
                 scan=ssm_lib.kernel_scan, shard_act=Identity):
        self.cfg = cfg
        self.attention = attention
        self.scan = scan
        self.shard_act = shard_act

    def init(self, seed: int = 0, device="cuda",
             trainable: bool = False) -> tf.ParamTree:
        """Parameters drawn from a ``torch.Generator`` seeded with ``seed``
        on ``device``: a serving tree, or with ``trainable`` fp32 masters
        that require gradients.  On the meta device: shapes and dtypes
        only."""
        if torch.device(device).type == "meta":
            gen = ShapeOnly()
        else:
            gen = torch.Generator(device=torch.device(device))
            gen.manual_seed(seed)
        with torch.no_grad():
            return tf.lm_init(gen, self.cfg, trainable)

    def abstract_params(self, seed: int = 0,
                        trainable: bool = True) -> tf.ParamTree:
        """The parameters on the meta device: the trainable fp32 tree (the
        reference's dtypes), or with ``trainable=False`` the serving
        tree."""
        return self.init(seed, "meta", trainable)

    def abstract_cache(self, batch: int, max_len: int) -> dict:
        return self.init_cache(batch, max_len, "meta")

    def reference_ndims(self, params: tf.ParamTree) -> list[int]:
        """Each parameter's dims (in ``params.parameters()`` order) in
        the reference's pytree, where every layer of a full pattern group
        is stacked [G, ...] with its group's: AdamW's decay rule reads
        them."""
        cfg = self.cfg
        scanned = {"stack": len(cfg.pattern) * (cfg.n_layers
                                                 // len(cfg.pattern)),
                   "encoder.stack": cfg.encoder_layers}
        out = []
        for name, p in params.named_parameters():
            head, _, rest = name.partition(".layers.")
            stacked = head in scanned and \
                int(rest.split(".", 1)[0]) < scanned[head]
            out.append(p.dim() + int(stacked))
        return out

    def param_count(self, params: tf.ParamTree | None = None) -> int:
        """The parameters' count (of the abstract tree by default)."""
        params = self.abstract_params() if params is None else params
        return sum(p.numel() for p in params.parameters())

    def init_cache(self, batch_size: int, max_len: int, device="cuda") -> dict:
        cfg = self.cfg
        return {"stack": tf.stack_cache(cfg, cfg.pattern, cfg.n_layers,
                                        batch_size, max_len,
                                        torch.device(device)),
                "step": 0}

    def _memory(self, params, batch):
        if not self.cfg.n_memory:
            return None
        mem = batch["memory"].to(COMPUTE_DTYPE)
        if self.cfg.encoder_layers:
            mem = tf.encode_memory(params, self.cfg, mem,
                                   attention=self.attention,
                                   shard_act=self.shard_act)
        return mem

    def _apply(self, params, tokens, **kw):
        return tf.lm_apply(params, self.cfg, tokens, attention=self.attention,
                           scan=self.scan, shard_act=self.shard_act, **kw)

    def loss(self, params, batch) -> tuple[torch.Tensor, dict]:
        """Next-token loss (and its metrics) of ``batch["tokens"]``
        against ``batch["labels"]``; it records gradients where the
        parameters require them."""
        logits, _, aux = self._apply(params, batch["tokens"],
                                     memory=self._memory(params, batch))
        with span("model.loss"):
            l, metrics = tf.lm_loss(logits, batch["labels"])
        if self.cfg.n_experts:
            if self.cfg.moe_aux_coef:
                l = l + self.cfg.moe_aux_coef * aux
            metrics = dict(metrics, moe_aux=aux)
        return l, metrics

    def prefill(self, params, batch) -> tuple[torch.Tensor, dict]:
        """Logits [B, T, V] of ``batch["tokens"]`` and the caches after
        them (``batch["caches"]``, empty, or fresh ones sized to the
        prompt)."""
        tokens = batch["tokens"]
        b, t = tokens.shape
        with _serving(params):
            caches = batch.get("caches")
            if caches is None:
                caches = self.init_cache(b, t, tokens.device)
            logits, new_stack, _ = self._apply(
                params, tokens, caches=caches["stack"],
                memory=self._memory(params, batch), pos_offset=0)
        return logits, {"stack": new_stack, "step": caches["step"] + t}

    def decode(self, params, caches, tokens) -> tuple[torch.Tensor, dict]:
        with _serving(params):
            logits, new_stack, _ = self._apply(
                params, tokens, caches=caches["stack"], memory=None,
                pos_offset=caches["step"])
        return logits, {"stack": new_stack,
                        "step": caches["step"] + tokens.shape[1]}


def _serving(params):
    """``torch.inference_mode``; ``no_grad`` for DTensor parameters (a
    DTensor view cannot be made in inference mode)."""
    if is_dtensor(next(params.parameters())):
        return torch.no_grad()
    return torch.inference_mode()


def build_model(cfg: ArchConfig, *, attention=flash_prefill,
                scan=ssm_lib.kernel_scan, shard_act=Identity) -> Model:
    return Model(cfg, attention=attention, scan=scan, shard_act=shard_act)
