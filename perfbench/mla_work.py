"""The operations and bytes of the attention kernels' calls on latent
attention (MLA), whose queries and keys are wider than its values: the
``flash_attention`` and ``flash_attention_bwd`` calls counted at the true
widths (query/key ``dqk``, value ``dv``), whatever width the kernels
compute at (the program pads v to ``dqk`` and runs on a compiled width
that holds it), so the padding's waste shows as a lower share."""
from __future__ import annotations

from perfbench.work import (ATTN_BWD_SOFTMAX_FLOPS, ATTN_SOFTMAX_FLOPS, BF16,
                            FP32, attention_pairs, bound_s)


def attention_fwd(bh: int, t: int, dqk: int, dv: int, causal: bool = True
                  ) -> tuple[float, str]:
    """One forward call with its log-sum-exp: scores 2 dqk and context
    2 dv a needed (query, key) pair; q, k [BH, T, dqk] and v [BH, T, dv]
    bf16 read, the output [BH, T, dv] written, lse [BH, T] fp32 written."""
    pairs = bh * attention_pairs(t, t, causal)
    nbytes = bh * t * ((2 * dqk + 2 * dv) * BF16 + FP32)
    return bound_s(pairs * 2 * (dqk + dv), pairs * ATTN_SOFTMAX_FLOPS, nbytes)


def attention_bwd(bh: int, t: int, dqk: int, dv: int, causal: bool = True
                  ) -> tuple[float, str]:
    """One backward call: the five products a pair, three at the
    query/key width (the scores again, dQ = dS K, dK = dS^T Q) and two at
    the value width (dP = dO V^T, dV = P^T dO); q, k, v, do bf16 and lse
    fp32 read once, dq, dk, dv bf16 written once."""
    pairs = bh * attention_pairs(t, t, causal)
    nbytes = bh * t * ((4 * dqk + 3 * dv) * BF16 + FP32)
    return bound_s(pairs * 2 * (3 * dqk + 2 * dv),
                   pairs * ATTN_BWD_SOFTMAX_FLOPS, nbytes)
