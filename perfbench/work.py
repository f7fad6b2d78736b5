"""The yardstick's arithmetic: the H100's published peaks and the
operations and bytes of the hand-written kernels' calls, worked out from
shapes (the model's FLOPs and parameter counts are ``weights.py``'s).

The kernel counts follow the port's own accounting (``chip_smoke.py``'s
``kernel_bound_ms`` and ``bwd_bound_ms``, ``obs/profile.py``'s
``attention_work`` and ``scan_work``), copied here so that the benchmark
reads the same work whatever implements it.
"""
from __future__ import annotations

#: NVIDIA H100 SXM, data sheet, dense, at its 700 W limit
PEAK = {
    "bf16_flops": 989e12,        # tensor cores, bf16 products
    "fp32_flops": 67e12,         # CUDA cores
    "hbm_bytes": 3.35e12,        # bytes/s
}

#: per needed (query, key) pair beyond the two products' 4 d: scale,
#: running max, subtraction, exp and the denominator's sum
ATTN_SOFTMAX_FLOPS = 5
#: per pair in the backward: the five products (2 d each, bf16 on the
#: tensor cores) and P = exp(s - lse), dS = P (dP - D) in fp32
ATTN_BWD_PRODUCT_FLOPS, ATTN_BWD_SOFTMAX_FLOPS = 10, 4
#: the scan backward per (b, t, i, s): the forward's recompute and the
#: reverse step with its four sums' terms
SCAN_BWD_FLOPS = 30
BF16, FP32 = 2, 4


def bound_s(flops_bf16: float, flops_fp32: float, nbytes: float
            ) -> tuple[float, str]:
    """Least time on the card: the larger of the operations over their
    peaks and the bytes over HBM, and which of the two it is."""
    t_ops = flops_bf16 / PEAK["bf16_flops"] + flops_fp32 / PEAK["fp32_flops"]
    t_bytes = nbytes / PEAK["hbm_bytes"]
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def attention_pairs(t: int, s: int, causal: bool = True) -> float:
    """(query, key) pairs of one head: all T S, or with causal masking
    those with key <= query."""
    if not causal:
        return float(t) * s
    full = min(t, s)
    return full * (full + 1) / 2 + max(t - s, 0) * s


def attention_fwd(bh: int, t: int, d: int, causal: bool = True
                  ) -> tuple[float, str]:
    """One ``flash_attention`` call with its log-sum-exp (training): q, k,
    v [BH, T, d] bf16 read and the output written once, lse [BH, T] fp32
    written once."""
    pairs = bh * attention_pairs(t, t, causal)
    nbytes = 4 * bh * t * d * BF16 + bh * t * FP32
    return bound_s(pairs * 4 * d, pairs * ATTN_SOFTMAX_FLOPS, nbytes)


def attention_bwd(bh: int, t: int, d: int, causal: bool = True
                  ) -> tuple[float, str]:
    """One ``flash_attention_bwd`` call: q, k, v, do bf16 and lse fp32
    read once, dq, dk, dv bf16 written once."""
    pairs = bh * attention_pairs(t, t, causal)
    nbytes = 7 * bh * t * d * BF16 + bh * t * FP32
    return bound_s(pairs * ATTN_BWD_PRODUCT_FLOPS * d,
                   pairs * ATTN_BWD_SOFTMAX_FLOPS, nbytes)


def scan_fwd(b: int, t: int, i: int, s: int) -> tuple[float, str]:
    """One ``selective_scan`` call, fp32: B T I (7 S + 1) operations; xi,
    dt, B, C, a, h0 read and y, h_last written once."""
    flops = float(b) * t * i * (7 * s + 1)
    nbytes = (3 * b * t * i + 2 * b * t * s + i * s + 2 * b * i * s) * FP32
    return bound_s(0.0, flops, nbytes)


def scan_bwd(b: int, t: int, i: int, s: int) -> tuple[float, str]:
    """One ``selective_scan_bwd`` call, fp32: its eight inputs read once
    and its six gradients (shaped as the first six inputs) written once."""
    inputs = 3 * b * t * i + 2 * b * t * s + i * s + 2 * b * i * s
    outputs = 2 * b * t * i + 2 * b * t * s + i * s + b * i * s
    return bound_s(0.0, float(b) * t * i * s * SCAN_BWD_FLOPS,
                   (inputs + outputs) * FP32)


def mfu_percent(flops_per_token: float, tokens: float, seconds: float
                ) -> float:
    """Model FLOPs of ``tokens`` over ``seconds`` at the bf16 peak, in %."""
    return 100.0 * flops_per_token * tokens / (seconds * PEAK["bf16_flops"])
