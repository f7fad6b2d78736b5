"""Uniform model factory: ArchConfig -> (init, loss, prefill, decode, caches),
the reference's ``models/model.py`` in PyTorch.

``build_model`` takes the model's prefill attention and Mamba scan the way
``ExplorationEngine`` takes ``evaluator=``: the defaults
(``layers.flash_prefill``, ``ssm.kernel_scan``) launch the hand-written
``flash_attention`` and ``selective_scan`` kernels on the card and run the
reference's branches on the CPU; passing the plain twins
(``layers.attention_any``, ``ssm.plain_scan``) runs the same model without
the kernels.  Two models built from one config share their parameters.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import ssm as ssm_lib
from repro_torch.models import transformer as tf
from repro_torch.models.layers import COMPUTE_DTYPE, flash_prefill

MOE_AUX_COEF = 0.01


class Model:
    """The functions of one architecture over its parameters (a
    :class:`~repro_torch.models.transformer.ParamTree`).  ``loss`` is
    differentiable (the reference's, for ``jax.value_and_grad``);
    ``prefill`` and ``decode`` run under ``torch.inference_mode``."""

    def __init__(self, cfg: ArchConfig, *, attention=flash_prefill,
                 scan=ssm_lib.kernel_scan):
        self.cfg = cfg
        self.attention = attention
        self.scan = scan

    def init(self, seed: int = 0, device="cuda",
             trainable: bool = False) -> tf.ParamTree:
        """Parameters drawn from a ``torch.Generator`` seeded with ``seed``
        on ``device``: a serving tree, or with ``trainable`` fp32 masters
        that require gradients."""
        gen = torch.Generator(device=torch.device(device))
        gen.manual_seed(seed)
        with torch.no_grad():
            return tf.lm_init(gen, self.cfg, trainable)

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

    def param_count(self, params: tf.ParamTree) -> int:
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
                                   attention=self.attention)
        return mem

    def _apply(self, params, tokens, **kw):
        return tf.lm_apply(params, self.cfg, tokens, attention=self.attention,
                           scan=self.scan, **kw)

    def loss(self, params, batch) -> tuple[torch.Tensor, dict]:
        """Next-token loss (and its metrics) of ``batch["tokens"]``
        against ``batch["labels"]``; it records gradients where the
        parameters require them."""
        logits, _, aux = self._apply(params, batch["tokens"],
                                     memory=self._memory(params, batch))
        l, metrics = tf.lm_loss(logits, batch["labels"])
        if self.cfg.n_experts:
            l = l + MOE_AUX_COEF * aux
            metrics = dict(metrics, moe_aux=aux)
        return l, metrics

    @torch.inference_mode()
    def prefill(self, params, batch) -> tuple[torch.Tensor, dict]:
        """Logits [B, T, V] of ``batch["tokens"]`` and the caches after
        them (``batch["caches"]``, empty, or fresh ones sized to the
        prompt)."""
        tokens = batch["tokens"]
        b, t = tokens.shape
        caches = batch.get("caches")
        if caches is None:
            caches = self.init_cache(b, t, tokens.device)
        logits, new_stack, _ = self._apply(
            params, tokens, caches=caches["stack"],
            memory=self._memory(params, batch), pos_offset=0)
        return logits, {"stack": new_stack, "step": caches["step"] + t}

    @torch.inference_mode()
    def decode(self, params, caches, tokens) -> tuple[torch.Tensor, dict]:
        logits, new_stack, _ = self._apply(
            params, tokens, caches=caches["stack"], memory=None,
            pos_offset=caches["step"])
        return logits, {"stack": new_stack,
                        "step": caches["step"] + tokens.shape[1]}


def build_model(cfg: ArchConfig, *, attention=flash_prefill,
                scan=ssm_lib.kernel_scan) -> Model:
    return Model(cfg, attention=attention, scan=scan)
