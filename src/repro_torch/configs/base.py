"""Architecture config registry and the CIM-Tuner workload extraction bridge.

The port keeps the reference's :class:`ArchConfig` fields, so the ten arch
files are the same, but only the part the design-space exploration needs:
the matmul operator mix of one forward pass (:meth:`ArchConfig.workload`).
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

    def n_groups(self) -> tuple[int, int]:
        """(full scanned groups, remainder layers)."""
        g = len(self.pattern)
        return self.n_layers // g, self.n_layers % g

    def _layer_counts(self) -> dict[str, int]:
        """Layers per block kind (full scanned groups + remainder prefix)."""
        full, rem = self.n_groups()
        counts: dict[str, int] = {}
        for i, kind in enumerate(self.pattern):
            counts[kind] = counts.get(kind, 0) + full + (1 if i < rem else 0)
        return counts

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
