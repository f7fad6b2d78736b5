"""Architecture config system: one frozen dataclass per assigned arch,
a registry (``get_arch(<id>)``), the assigned input-shape set, parameter
estimates, reduced smoke configs, and the CIM-Tuner workload extraction
bridge (the matmul operator mix of one forward pass,
:meth:`ArchConfig.workload`).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional

from repro_torch.core.ir import (
    MatmulOp,
    Workload,
    lm_head_ops,
    ssm_layer_ops,
    transformer_layer_ops,
)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One assigned input shape (a dry-run cell column)."""

    name: str
    seq_len: int
    global_batch: int
    kind: str          # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    # identity
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    # backbone
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    # variants
    mlp_act: str = "swiglu"        # swiglu | geglu | gelu
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    rope_theta: Optional[float] = 1e4
    window: Optional[int] = None   # sliding-window attention
    tie_embeddings: bool = False
    emb_scale: bool = False        # gemma: embed * sqrt(d)
    # MoE
    n_experts: int = 0
    moe_top_k: int = 0
    # SSM (mamba)
    ssm_state: int = 0
    ssm_conv: int = 4
    d_inner: int = 0
    dt_rank: int = 0
    # hybrid (griffin): block pattern, e.g. ("rglru", "rglru", "local_attn")
    pattern: tuple[str, ...] = ("dense",)
    # cross-attention memory (vlm / audio encoder output)
    n_memory: int = 0              # stub tokens provided by input_specs
    encoder_layers: int = 0        # audio enc-dec
    max_decode_len: int = 32768    # learned-position table size (audio)
    # training/runtime policy
    fsdp: bool = False             # shard params over the data axis too
    shard_attn: bool = True        # head-shard attention over "model"
    remat: bool = True
    scan_layers: bool = True
    # ---- perf-variant switches (EXPERIMENTS.md Sec. Perf levers) ----
    moe_row_dispatch: bool = False   # per-batch-row-local MoE dispatch
    cast_params_bf16: bool = False   # one-time bf16 weight cast per step
    remat_policy: str = "full"       # "full" | "dots" (save matmul outputs)
    ssm_fused_coeffs: bool = False   # compute scan coeffs inside the chunk
    ssm_chunk: int = 256             # linear-scan chunk length
    seq_shard_attn: bool = False     # context-parallel attention (q-seq over
                                     # "model") for archs whose head count
                                     # doesn't divide the TP axis
    # which assigned shapes run (long_500k only for sub-quadratic archs)
    skip_shapes: tuple[str, ...] = ()

    # ------------------------------------------------------------------ #
    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def group_pattern(self) -> tuple[str, ...]:
        return self.pattern

    def n_groups(self) -> tuple[int, int]:
        """(full scanned groups, remainder layers)."""
        g = len(self.pattern)
        return self.n_layers // g, self.n_layers % g

    def _layer_params(self, kind: str) -> int:
        d = self.d_model
        attn = d * (self.n_heads + 2 * self.n_kv_heads) * self.head_dim \
            + self.n_heads * self.head_dim * d
        if kind in ("dense", "local_attn", "self", "enc_self"):
            return attn + self._ffn_params()
        if kind == "moe":
            return attn + d * self.n_experts + \
                self.n_experts * self._ffn_params()
        if kind == "mamba":
            i = self.d_inner
            return (d * 2 * i + i * (self.dt_rank + 2 * self.ssm_state)
                    + self.dt_rank * i + i * d + i * self.ssm_state)
        if kind == "rglru":
            i = self.d_inner
            return d * 2 * i + 2 * i * i + i * d + self._ffn_params()
        if kind == "cross":
            return attn + self._ffn_params()
        if kind == "dec_self_cross":
            return 2 * attn + self._ffn_params()
        raise ValueError(f"unknown block kind {kind}")

    def _layer_counts(self) -> dict[str, int]:
        """Layers per block kind (full scanned groups + remainder prefix)."""
        full, rem = self.n_groups()
        counts: dict[str, int] = {}
        for i, kind in enumerate(self.pattern):
            counts[kind] = counts.get(kind, 0) + full + (1 if i < rem else 0)
        return counts

    def params_estimate(self) -> int:
        """Parameter count (drives roofline MODEL_FLOPS = 6*N*D)."""
        n = sum(self._layer_params(k) * c
                for k, c in self._layer_counts().items())
        n += self.vocab * self.d_model * (1 if self.tie_embeddings else 2)
        if self.encoder_layers:
            n += self.encoder_layers * self._layer_params("enc_self")
        return n

    def _ffn_params(self) -> int:
        gated = self.mlp_act in ("swiglu", "geglu")
        return self.d_model * self.d_ff * (3 if gated else 2)

    def active_params_estimate(self) -> int:
        """MoE: only top-k experts count toward MODEL_FLOPS."""
        if not self.n_experts:
            return self.params_estimate()
        full = self.params_estimate()
        inactive = (self.n_experts - self.moe_top_k) * self._ffn_params() \
            * self.n_layers
        return full - inactive

    # ------------------------------------------------------------------ #
    def reduced(self) -> "ArchConfig":
        """Family-faithful small config for CPU smoke tests."""
        g = len(self.pattern)
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=max(g, 2 if g == 1 else g),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads > 1 else 1,
            head_dim=16,
            d_ff=0 if self.d_ff == 0 else 128,
            vocab=512,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            moe_top_k=min(self.moe_top_k, 2) if self.moe_top_k else 0,
            ssm_state=min(self.ssm_state, 8) if self.ssm_state else 0,
            d_inner=128 if self.d_inner else 0,
            dt_rank=8 if self.dt_rank else 0,
            window=min(self.window, 32) if self.window else None,
            n_memory=16 if self.n_memory else 0,
            encoder_layers=2 if self.encoder_layers else 0,
            max_decode_len=128,
            fsdp=False,
        )

    # ------------------------------------------------------------------ #
    # CIM-Tuner bridge: extract the matmul operator mix of one forward pass
    # ------------------------------------------------------------------ #
    def workload(self, seq: int = 512, include_lm_head: bool = True) -> Workload:
        ops: list[MatmulOp] = []
        for kind, cnt in self._layer_counts().items():
            layer = self._layer_ops(kind, seq)
            ops.extend(
                dataclasses.replace(o, count=o.count * cnt) for o in layer
            )
        if self.encoder_layers:
            enc = transformer_layer_ops(
                seq=self.n_memory or 1500, d_model=self.d_model,
                n_heads=self.n_heads, n_kv_heads=self.n_kv_heads,
                head_dim=self.head_dim, d_ff=self.d_ff,
                gated_ffn=self.mlp_act in ("swiglu", "geglu"),
                prefix="enc_")
            ops.extend(
                dataclasses.replace(o, count=o.count * self.encoder_layers)
                for o in enc)
        if include_lm_head:
            ops.extend(lm_head_ops(seq=seq, d_model=self.d_model,
                                   vocab=self.vocab))
        return Workload(self.name, tuple(ops)).merged()

    def _layer_ops(self, kind: str, seq: int) -> list[MatmulOp]:
        gated = self.mlp_act in ("swiglu", "geglu")
        common = dict(
            seq=seq, d_model=self.d_model, n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads, head_dim=self.head_dim,
            gated_ffn=gated,
        )
        if kind in ("dense", "self", "enc_self"):
            return transformer_layer_ops(
                d_ff=self.d_ff, window=self.window, **common)
        if kind == "local_attn":
            return transformer_layer_ops(
                d_ff=self.d_ff, window=self.window or 2048, **common)
        if kind == "moe":
            return transformer_layer_ops(
                d_ff=self.d_ff, n_experts=self.n_experts,
                top_k=self.moe_top_k, window=self.window, **common)
        if kind == "mamba":
            return ssm_layer_ops(
                seq=seq, d_model=self.d_model, d_inner=self.d_inner,
                d_state=self.ssm_state, dt_rank=self.dt_rank)
        if kind == "rglru":
            i = self.d_inner
            ffn = transformer_layer_ops(d_ff=self.d_ff, **common)[-2:]
            return [
                MatmulOp(seq, self.d_model, 2 * i, name="rg_in"),
                MatmulOp(seq, i, i, count=2, name="rg_gates"),
                MatmulOp(seq, i, self.d_model, name="rg_out"),
            ] + ffn
        if kind in ("cross", "dec_self_cross"):
            return transformer_layer_ops(
                d_ff=self.d_ff, window=self.window,
                cross_attn_src=self.n_memory or 1500, **common)
        raise ValueError(f"unknown block kind {kind}")


# ---------------------------------------------------------------------- #
# registry
# ---------------------------------------------------------------------- #
ARCH_IDS = (
    "yi-6b", "gemma-7b", "mistral-nemo-12b", "h2o-danube-3-4b",
    "recurrentgemma-9b", "falcon-mamba-7b", "llama-3.2-vision-90b",
    "granite-moe-3b-a800m", "mixtral-8x7b", "whisper-small",
)

_MODULES = {
    "yi-6b": "yi_6b",
    "gemma-7b": "gemma_7b",
    "mistral-nemo-12b": "mistral_nemo_12b",
    "h2o-danube-3-4b": "h2o_danube3_4b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "llama-3.2-vision-90b": "llama32_vision_90b",
    "granite-moe-3b-a800m": "granite_moe_3b",
    "mixtral-8x7b": "mixtral_8x7b",
    "whisper-small": "whisper_small",
}


def get_arch(name: str) -> ArchConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; available: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG


def all_archs() -> dict[str, ArchConfig]:
    return {a: get_arch(a) for a in ARCH_IDS}
