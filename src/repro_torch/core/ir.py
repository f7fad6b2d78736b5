"""Operator intermediate representation (IR) and operator-size-aware merging.

CIM-Tuner represents target workloads through an IR that extracts matrix
dimensions (paper Sec. III-A).  A workload is a list of ``MatmulOp``s
(M x K @ K x N, with multiplicity).  Operators of the same size are merged
(Sec. III-D) which shrinks the per-network mapping-strategy space -- the
80 %+ runtime reduction of Fig. 9.

``weights_static`` distinguishes parameter matmuls (weights can live in CIM
across an inference) from activation x activation GEMMs (attention score /
context products) whose "stationary" operand must be re-written per call.
Both are mappable -- the reversed (R) spatial scheduling exists precisely to
let either operand be the CIM-resident one -- the flag only documents the
distinction and is consumed by the energy model's update accounting.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict

import numpy as np


@dataclasses.dataclass(frozen=True)
class MatmulOp:
    """One (M, K) x (K, N) matrix multiplication, repeated ``count`` times."""

    m: int
    k: int
    n: int
    count: int = 1
    weights_static: bool = True
    name: str = ""

    def __post_init__(self) -> None:
        if min(self.m, self.k, self.n) <= 0 or self.count <= 0:
            raise ValueError(f"invalid MatmulOp dims: {self}")

    @property
    def macs(self) -> int:
        return self.m * self.k * self.n * self.count

    @property
    def ops(self) -> int:
        return 2 * self.macs

    def key(self) -> tuple[int, int, int, bool]:
        return (self.m, self.k, self.n, self.weights_static)


@dataclasses.dataclass(frozen=True)
class Workload:
    """A named bag of matmul operators (one DNN's GEMM mix)."""

    name: str
    ops: tuple[MatmulOp, ...]

    def __post_init__(self) -> None:
        if not self.ops:
            raise ValueError(f"workload {self.name!r} has no operators")

    @property
    def total_macs(self) -> int:
        return sum(op.macs for op in self.ops)

    @property
    def total_ops(self) -> int:
        return 2 * self.total_macs

    def merged(self) -> "Workload":
        """Operator-size-aware merging: gather same-size operators."""
        acc: OrderedDict[tuple, list] = OrderedDict()
        for op in self.ops:
            k = op.key()
            if k in acc:
                acc[k][0] += op.count
            else:
                acc[k] = [op.count, op]
        merged = tuple(
            dataclasses.replace(op, count=cnt, name=op.name or f"op{i}")
            for i, (cnt, op) in enumerate(acc.values())
        )
        return Workload(name=self.name, ops=merged)

    # ------------------------------------------------------------------ #
    # Vectorized view for the tensor cost model: fixed-width arrays, padded
    # with count == 0 sentinel rows (cost model treats count 0 as "absent").
    # ------------------------------------------------------------------ #
    def as_arrays(self, pad_to: int | None = None):
        n = len(self.ops)
        width = pad_to if pad_to is not None else n
        if width < n:
            raise ValueError(f"pad_to={pad_to} < num ops {n}")
        out = np.zeros((width, 5), dtype=np.float64)
        for i, op in enumerate(self.ops):
            out[i] = (op.m, op.k, op.n, op.count, float(op.weights_static))
        out[n:, :3] = 1.0  # keep dims positive for padded rows
        return out


# ---------------------------------------------------------------------- #
# Transformer-family operator extraction.  These helpers build workloads
# straight from layer hyperparameters; ``repro.configs`` adds per-arch
# wrappers on top so the DSE runs on the assigned architectures.
# ---------------------------------------------------------------------- #
def transformer_layer_ops(
    *,
    seq: int,
    d_model: int,
    n_heads: int,
    n_kv_heads: int,
    head_dim: int,
    d_ff: int,
    gated_ffn: bool = True,
    n_experts: int = 0,
    top_k: int = 0,
    window: int | None = None,
    cross_attn_src: int | None = None,
    prefix: str = "",
) -> list[MatmulOp]:
    """GEMM mix of one decoder layer at a given sequence length.

    Attention score/context products are emitted per head-group with
    ``weights_static=False``.  With sliding-window attention the effective
    attended length is capped at ``window``.
    """
    ops: list[MatmulOp] = []
    q_dim = n_heads * head_dim
    kv_dim = n_kv_heads * head_dim

    ops.append(MatmulOp(seq, d_model, q_dim, name=f"{prefix}q_proj"))
    ops.append(MatmulOp(seq, d_model, kv_dim, count=2, name=f"{prefix}kv_proj"))
    ops.append(MatmulOp(seq, q_dim, d_model, name=f"{prefix}o_proj"))

    att_len = min(seq, window) if window else seq
    # score: (seq x head_dim) @ (head_dim x att_len), one per head
    ops.append(MatmulOp(seq, head_dim, att_len, count=n_heads,
                        weights_static=False, name=f"{prefix}attn_score"))
    # context: (seq x att_len) @ (att_len x head_dim)
    ops.append(MatmulOp(seq, att_len, head_dim, count=n_heads,
                        weights_static=False, name=f"{prefix}attn_ctx"))

    if cross_attn_src is not None:
        ops.append(MatmulOp(seq, d_model, q_dim, name=f"{prefix}xq_proj"))
        ops.append(MatmulOp(cross_attn_src, d_model, kv_dim, count=2,
                            name=f"{prefix}xkv_proj"))
        ops.append(MatmulOp(seq, q_dim, d_model, name=f"{prefix}xo_proj"))
        ops.append(MatmulOp(seq, head_dim, cross_attn_src, count=n_heads,
                            weights_static=False, name=f"{prefix}xattn_score"))
        ops.append(MatmulOp(seq, cross_attn_src, head_dim, count=n_heads,
                            weights_static=False, name=f"{prefix}xattn_ctx"))

    if n_experts and top_k:
        # router + top_k active expert FFNs per token (dense equivalent:
        # every token hits top_k experts -> count = top_k per matmul)
        ops.append(MatmulOp(seq, d_model, n_experts, name=f"{prefix}router"))
        up_count = 2 * top_k if gated_ffn else top_k
        ops.append(MatmulOp(seq, d_model, d_ff, count=up_count,
                            name=f"{prefix}moe_up"))
        ops.append(MatmulOp(seq, d_ff, d_model, count=top_k,
                            name=f"{prefix}moe_down"))
    elif d_ff > 0:
        up_count = 2 if gated_ffn else 1
        ops.append(MatmulOp(seq, d_model, d_ff, count=up_count,
                            name=f"{prefix}ffn_up"))
        ops.append(MatmulOp(seq, d_ff, d_model, name=f"{prefix}ffn_down"))
    return ops


def ssm_layer_ops(
    *,
    seq: int,
    d_model: int,
    d_inner: int,
    d_state: int,
    dt_rank: int,
    prefix: str = "",
) -> list[MatmulOp]:
    """Mamba-1 block GEMM mix (the selective scan itself is elementwise and
    out of CIM-Tuner scope -- see DESIGN.md Arch-applicability)."""
    return [
        MatmulOp(seq, d_model, 2 * d_inner, name=f"{prefix}in_proj"),
        MatmulOp(seq, d_inner, dt_rank + 2 * d_state, name=f"{prefix}x_proj"),
        MatmulOp(seq, dt_rank, d_inner, name=f"{prefix}dt_proj"),
        MatmulOp(seq, d_inner, d_model, name=f"{prefix}out_proj"),
    ]


def lm_head_ops(*, seq: int, d_model: int, vocab: int) -> list[MatmulOp]:
    return [MatmulOp(seq, d_model, vocab, name="lm_head")]


def bert_large_workload(seq: int = 512) -> Workload:
    """Bert-large [4]: 24 layers, d=1024, 16 heads, ff=4096 (Fig. 8 /
    Table II workload)."""
    layer = transformer_layer_ops(
        seq=seq, d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64,
        d_ff=4096, gated_ffn=False,
    )
    ops = [dataclasses.replace(op, count=op.count * 24) for op in layer]
    return Workload("bert-large", tuple(ops)).merged()


def bert_large_fig8_ops() -> Workload:
    """The three Bert-large matmul operators used in the Fig. 8 breakdown:
    QKV projection, FFN up, FFN down (seq = 512)."""
    return Workload(
        "bert-large-fig8",
        (
            MatmulOp(512, 1024, 1024, count=3, name="qkv_proj"),
            MatmulOp(512, 1024, 4096, name="ffn_up"),
            MatmulOp(512, 4096, 1024, name="ffn_down"),
        ),
    )
