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
    n_experts: int = 0             # routed experts held here
    moe_top_k: int = 0
    # expert parallelism and DeepSeek-style MoE layers (0 / defaults: off)
    router_experts: int = 0        # experts the router scores (0: n_experts)
    expert_offset: int = 0         # the first routed expert held here
    shared_d_ff: int = 0           # shared experts' SwiGLU width
    dense_d_ff: int = 0            # leading dense layers' MLP width (0: d_ff)
    moe_aux_coef: float = 0.01     # load-balancing loss weight
    # latent attention (MLA); a width of 0 means no MLA
    kv_lora_rank: int = 0          # the key/value latent's width
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    # YaRN rotary scaling of the rope part (factor 0: none); one mscale for
    # the attention scale and the rope (DeepSeek's two are equal, so cos and
    # sin are unscaled)
    yarn_factor: float = 0.0
    yarn_original_len: int = 0
    yarn_beta_fast: float = 32.0
    yarn_beta_slow: float = 1.0
    yarn_mscale: float = 0.0       # mscale_all_dim: m = 0.1 mscale ln(factor) + 1
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
        if kind == "mla_dense":
            return self._mla_params() + self._ffn_params(
                self.dense_d_ff or self.d_ff)
        if kind == "mla_moe":
            return (self._mla_params() + d * self.n_routed
                    + self.n_experts * self._ffn_params()
                    + self._ffn_params(self.shared_d_ff))
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

    def _ffn_params(self, d_ff: int | None = None) -> int:
        gated = self.mlp_act in ("swiglu", "geglu")
        d_ff = self.d_ff if d_ff is None else d_ff
        return self.d_model * d_ff * (3 if gated else 2)

    @property
    def n_routed(self) -> int:
        """The experts the router scores: all of the layer's, of which
        this chip holds ``n_experts`` from ``expert_offset`` on."""
        return self.router_experts or self.n_experts

    @property
    def qk_head_dim(self) -> int:
        """MLA's query and key width: the no-rope and the rope parts."""
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    def _mla_params(self) -> int:
        """MLA's matrices (no norms): W_q, W_kva (latent and shared rope
        key), W_kvb (each head's key and value from the latent), W_o."""
        d, h, r = self.d_model, self.n_heads, self.kv_lora_rank
        return (d * h * self.qk_head_dim + d * (r + self.qk_rope_head_dim)
                + r * h * (self.qk_nope_head_dim + self.v_head_dim)
                + h * self.v_head_dim * d)

    def active_params_estimate(self) -> int:
        """MoE: only the experts a token is routed to count toward
        MODEL_FLOPS (with experts held here out of more routed, the top-k
        at the held share)."""
        if not self.n_experts:
            return self.params_estimate()
        full = self.params_estimate()
        layers = sum(c for k, c in self._layer_counts().items()
                     if k in ("moe", "mla_moe"))
        active = self.moe_top_k * self.n_experts / self.n_routed
        return full - round((self.n_experts - active) * self._ffn_params()
                            * layers)

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
            router_experts=min(self.router_experts, 8),
            shared_d_ff=min(self.shared_d_ff, 128),
            dense_d_ff=min(self.dense_d_ff, 128),
            kv_lora_rank=min(self.kv_lora_rank, 32),
            qk_nope_head_dim=min(self.qk_nope_head_dim, 16),
            qk_rope_head_dim=min(self.qk_rope_head_dim, 8),
            v_head_dim=min(self.v_head_dim, 16),
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
        if kind in ("mla_dense", "mla_moe"):
            return self._mla_ops(kind, seq)
        raise ValueError(f"unknown block kind {kind}")

    def _mla_ops(self, kind: str, seq: int) -> list[MatmulOp]:
        """An MLA layer's products: the query, latent and per-head key /
        value projections, scores at the query/key width, context at the
        value width, the output; then the dense MLP, or the router, the
        routed experts (top-k a token, over the whole deployment) and the
        shared experts."""
        d, h, r = self.d_model, self.n_heads, self.kv_lora_rank
        dqk, dv = self.qk_head_dim, self.v_head_dim
        ops = [MatmulOp(seq, d, h * dqk, name="q_proj"),
               MatmulOp(seq, d, r + self.qk_rope_head_dim, name="kv_a_proj"),
               MatmulOp(seq, r, h * (self.qk_nope_head_dim + dv),
                        name="kv_b_proj"),
               MatmulOp(seq, h * dv, d, name="o_proj"),
               MatmulOp(seq, dqk, seq, count=h, weights_static=False,
                        name="attn_score"),
               MatmulOp(seq, seq, dv, count=h, weights_static=False,
                        name="attn_ctx")]
        ffn = lambda f, n, k=1: [
            MatmulOp(seq, d, f, count=2 * k, name=f"{n}_up"),
            MatmulOp(seq, f, d, count=k, name=f"{n}_down")]
        if kind == "mla_dense":
            return ops + ffn(self.dense_d_ff or self.d_ff, "ffn")
        ops.append(MatmulOp(seq, d, self.n_routed, name="router"))
        ops += ffn(self.d_ff, "moe", self.moe_top_k)
        if self.shared_d_ff:
            ops += ffn(self.shared_d_ff, "shared")
        return ops


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
    # port-only: the benchmark's latent-attention MoE configuration; not in
    # ARCH_IDS, which lists the reference's ten, whose JAX package has no
    # MLA block to hold the port against
    "deepseek-v2-lite": "deepseek_v2_lite",
}


def get_arch(name: str) -> ArchConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; available: "
                       f"{tuple(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG


def all_archs() -> dict[str, ArchConfig]:
    return {a: get_arch(a) for a in ARCH_IDS}
