"""Shared neural blocks: norms, RoPE, GQA attention (dense / streaming /
local-window / decode), gated MLPs, embeddings -- the reference's
``models/layers.py`` in PyTorch, plus the prefill route through the
hand-written ``flash_attention`` kernel (:func:`flash_prefill`).

Conventions (the reference's):
  * params are nested mappings of tensors (``p["wq"]``); the model keeps
    each weight in the dtype its forward reads it in (see
    ``transformer.storage_dtype``), a function casts on use as the
    reference does, a no-op for a weight already in that dtype;
  * activations compute in bf16 with fp32 softmax/norm statistics, and
    each bf16 rounding sits where the reference puts it;
  * tensor layouts: activations [B, T, D]; attention heads [B, T, H, dh];
    KV caches [B, S, KH, dh].
Initialisers draw from an explicit ``torch.Generator`` on its device.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ops
from repro_torch.models import sharding as sh

COMPUTE_DTYPE = torch.bfloat16
NEG_INF = -1e30


# the activations op by op as JAX lowers them, each op rounded to the
# input's dtype and the constants in it (a fused torch kernel rounds once)
def _const(c: float, x: torch.Tensor) -> torch.Tensor:
    return torch.tensor(c, dtype=x.dtype, device=x.device)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid``: 1 / (1 + exp(-x))."""
    return 1 / (1 + torch.exp(-x))


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: x * sigmoid(x)."""
    return x * sigmoid(x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation (torch's default
    is the erf form)."""
    inner = _const(math.sqrt(2 / math.pi), x) * (
        x + _const(0.044715, x) * (x * x * x))
    return x * (_const(0.5, x) * (1 + torch.tanh(inner)))


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + exp(x)) as max(x, 0) + log1p(exp(-|x|))."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-torch.abs(x)))


# ---------------------------------------------------------------------- #
# init helpers
# ---------------------------------------------------------------------- #
class ShapeOnly:
    """Stands in for a ``torch.Generator`` to make parameters on the meta
    device (which has no generator): the initialisers then give shapes
    and dtypes, with no draw and no allocation."""
    device = torch.device("meta")


def normal(gen: torch.Generator, shape, scale: float = 1.0) -> torch.Tensor:
    """fp32 standard normal draws from ``gen`` on its device, times
    ``scale`` (an fp32 meta tensor of the shape for :class:`ShapeOnly`)."""
    if gen.device.type == "meta":
        return torch.empty(shape, dtype=torch.float32, device="meta")
    return torch.randn(shape, generator=gen, device=gen.device,
                       dtype=torch.float32) * scale


def dense_init(gen, d_in: int, d_out: int, scale: float | None = None):
    s = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return normal(gen, (d_in, d_out), s)


def embed_init(gen, vocab: int, d: int):
    return normal(gen, (vocab, d), 0.02)


# ---------------------------------------------------------------------- #
# norms
# ---------------------------------------------------------------------- #
def rmsnorm_params(d: int, device=None) -> dict:
    return {"scale": torch.zeros((d,), dtype=torch.float32, device=device)}


def rmsnorm(p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return _rmsnorm(p, x, eps).to(x.dtype)


def _rmsnorm(p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """The norm in fp32, before its cast back to ``x``'s dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return xf * torch.rsqrt(var + eps) * (1.0 + p["scale"])


def layernorm_params(d: int, device=None) -> dict:
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device),
            "bias": torch.zeros((d,), dtype=torch.float32, device=device)}


def layernorm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    return _layernorm(p, x, eps).to(x.dtype)


def _layernorm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    return (xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]


def apply_norm(kind: str, p, x: torch.Tensor) -> torch.Tensor:
    """A DTensor ``x`` (a model on a mesh) is normed on each rank's local
    rows (``sharding.local_rowwise``) in fp32 and cast back outside them,
    so that the gradient that reaches the norm with its sums pending is
    summed across ranks in fp32."""
    if not sh.is_dtensor(x):
        return rmsnorm(p, x) if kind == "rmsnorm" else layernorm(p, x)
    if kind == "rmsnorm":
        y = sh.local_rowwise(lambda x, s: _rmsnorm({"scale": s}, x), x,
                             p["scale"])
    else:
        y = sh.local_rowwise(
            lambda x, s, b: _layernorm({"scale": s, "bias": b}, x), x,
            p["scale"], p["bias"])
    return y.to(x.dtype)


def norm_params(kind: str, d: int, device=None) -> dict:
    return rmsnorm_params(d, device) if kind == "rmsnorm" else \
        layernorm_params(d, device)


# ---------------------------------------------------------------------- #
# rotary position embeddings
# ---------------------------------------------------------------------- #
def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [B, T, H, dh]; positions: [B, T] (absolute).  A DTensor ``x``
    is rotated on each rank's local rows (``sharding.local_rowwise``)."""
    if sh.is_dtensor(x):
        return sh.local_rowwise(lambda x, pos: rope(x, pos, theta), x,
                                positions, positional=True)
    dh = x.shape[-1]
    half = dh // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions[..., None].float() * freq                # [B, T, half]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------- #
# attention cores
# ---------------------------------------------------------------------- #
def _expand_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """[B, S, KH, dh] -> [B, S, H, dh] by repeating each kv head: head h
    reads kv head h // rep (``jnp.repeat``, i.e. ``repeat_interleave``)."""
    rep = n_heads // k.shape[2]
    if rep == 1:
        return k
    return torch.repeat_interleave(k, rep, dim=2)


def _positions(n: int, device, offset=0) -> torch.Tensor:
    return torch.arange(n, device=device) + offset


def dense_attention(
    q: torch.Tensor,            # [B, T, H, dh]
    k: torch.Tensor,            # [B, S, KH, dh]
    v: torch.Tensor,
    *,
    causal: bool,
    window: int | None = None,
    q_offset: int = 0,          # absolute position of q[0] (decode: S-1)
) -> torch.Tensor:
    """Materialized-scores attention; use for T*S small enough and for
    single-token decode."""
    h = q.shape[2]
    k = _expand_kv(k, h)
    v = _expand_kv(v, h)
    dh = q.shape[-1]
    scores = torch.einsum(
        "bthd,bshd->bhts", q.to(COMPUTE_DTYPE), k.to(COMPUTE_DTYPE)
    ).float() / math.sqrt(dh)
    t, s = scores.shape[-2], scores.shape[-1]
    qpos = _positions(t, q.device, q_offset)
    kpos = _positions(s, q.device)
    mask = torch.ones((t, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        mask &= kpos[None, :] > qpos[:, None] - window
    scores = torch.where(mask[None, None], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1).to(COMPUTE_DTYPE)
    return torch.einsum("bhts,bshd->bthd", p, v.to(COMPUTE_DTYPE))


def streaming_attention(
    q: torch.Tensor,            # [B, T, H, dh]
    k: torch.Tensor,            # [B, S, KH, dh]
    v: torch.Tensor,
    *,
    causal: bool,
    kv_block: int = 1024,
    q_offset: int = 0,
) -> torch.Tensor:
    """Flash-style streaming softmax over KV blocks (the reference's
    ``lax.scan`` as a loop): memory O(T * kv_block) per head."""
    b, t, h, dh = q.shape
    s = k.shape[1]
    pad = (-s) % kv_block
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    nblk = k.shape[1] // kv_block
    qf = q.to(COMPUTE_DTYPE)
    qpos = _positions(t, q.device, q_offset)
    scale = 1.0 / math.sqrt(dh)
    m = torch.full((b, h, t), -math.inf, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, t), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, t, h, dh), dtype=torch.float32, device=q.device)
    for blk in range(nblk):
        sl = slice(blk * kv_block, (blk + 1) * kv_block)
        kblk = _expand_kv(k[:, sl], h)
        vblk = _expand_kv(v[:, sl], h)
        sc = torch.einsum("bthd,bshd->bhts", qf, kblk.to(COMPUTE_DTYPE))
        sc = sc.float() * scale
        kpos = blk * kv_block + _positions(kv_block, q.device)
        mask = kpos[None, :] < s                       # padding
        if causal:
            mask = mask & (kpos[None, :] <= qpos[:, None])
        sc = torch.where(mask[None, None], sc, NEG_INF)
        m_new = torch.maximum(m, sc.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(sc - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        pv = torch.einsum("bhts,bshd->bthd", p.to(COMPUTE_DTYPE),
                          vblk.to(COMPUTE_DTYPE)).float()
        acc = acc * alpha.transpose(1, 2)[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l, min=1e-30).transpose(1, 2)[..., None]
    return out.to(COMPUTE_DTYPE)


def local_chunk_attention(
    q: torch.Tensor,            # [B, T, H, dh]
    k: torch.Tensor,            # [B, T, KH, dh]
    v: torch.Tensor,
    *,
    window: int,
) -> torch.Tensor:
    """Causal sliding-window attention in O(T * window): each window-sized
    chunk attends to itself + the previous chunk (exact for window <=
    chunk)."""
    b, t, h, dh = q.shape
    kh = k.shape[2]
    w = window
    pad = (-t) % w
    if pad:
        q, k, v = (F.pad(x, (0, 0, 0, 0, 0, pad)) for x in (q, k, v))
    tp = q.shape[1]
    nc = tp // w
    qc = q.reshape(b, nc, w, h, dh)
    kc = k.reshape(b, nc, w, kh, dh)
    vc = v.reshape(b, nc, w, kh, dh)
    # previous chunk (zeros before the first)
    k_prev = torch.cat([torch.zeros_like(kc[:, :1]), kc[:, :-1]], dim=1)
    v_prev = torch.cat([torch.zeros_like(vc[:, :1]), vc[:, :-1]], dim=1)
    kk = torch.cat([k_prev, kc], dim=2)               # [B, nc, 2w, KH, dh]
    vv = torch.cat([v_prev, vc], dim=2)
    kk = _expand_kv(kk.reshape(b * nc, 2 * w, kh, dh), h)
    vv = _expand_kv(vv.reshape(b * nc, 2 * w, kh, dh), h)
    qq = qc.reshape(b * nc, w, h, dh)

    sc = torch.einsum("bthd,bshd->bhts", qq.to(COMPUTE_DTYPE),
                      kk.to(COMPUTE_DTYPE)).float() / math.sqrt(dh)
    qpos = _positions(w, q.device, w)                 # within the 2w slab
    kpos = _positions(2 * w, q.device)
    mask = (kpos[None, :] <= qpos[:, None]) & (kpos[None, :] > qpos[:, None] - w)
    # first chunk has no previous block
    first = (_positions(b * nc, q.device) % nc) == 0
    mask_first = mask & (kpos[None, :] >= w)
    full_mask = torch.where(first[:, None, None, None], mask_first[None, None],
                            mask[None, None])
    sc = torch.where(full_mask, sc, NEG_INF)
    p = torch.softmax(sc, dim=-1).to(COMPUTE_DTYPE)
    out = torch.einsum("bhts,bshd->bthd", p, vv.to(COMPUTE_DTYPE))
    return out.reshape(b, tp, h, dh)[:, :t]


def attention_any(
    q, k, v, *, causal: bool, window: int | None, q_offset: int = 0,
    dense_limit: int = 8192,
) -> torch.Tensor:
    """Dispatch to the right attention core for the shapes at hand (the
    plain twin of :func:`flash_prefill`)."""
    t, s = q.shape[1], k.shape[1]
    if window is not None and t == s and t > window:
        return local_chunk_attention(q, k, v, window=window)
    if t == 1 or (t * s) <= dense_limit * dense_limit // 4:
        return dense_attention(q, k, v, causal=causal, window=window,
                               q_offset=q_offset)
    return streaming_attention(q, k, v, causal=causal, q_offset=q_offset)


def _flash_autograd(q, k, v, *, causal: bool) -> torch.Tensor:
    return ops.FlashAttention.apply(q, k, v, causal)


def flash_prefill(q, k, v, *, causal: bool, window: int | None,
                  kernel=None) -> torch.Tensor:
    """Prefill self-attention through the ``flash_attention`` kernel.

    ``kernel`` has ``ops.flash_attention``'s signature (``q`` [BH, T, d],
    ``k``, ``v`` [BH, S, d]).  Left as None, it is the differentiable
    ``ops.FlashAttention`` (the forward kernel, and the backward kernel
    when a gradient is taken) for CUDA tensors, and for CPU tensors the
    whole call is :func:`attention_any`, the reference's branches.  The
    kernel takes self-attention at ``t > 1`` with no window or ``t <=
    window`` (where the window masks nothing); a longer windowed prefill
    is :func:`local_chunk_attention`.
    kv heads are expanded as ``_expand_kv`` does and the heads folded into
    the batch, bf16 and contiguous; the output is bf16 [B, T, H, dh] as
    the reference's.  A head width the kernel does not take (above 256,
    or not a multiple of 8: ``flash_attention.compiled_width``) raises.
    DTensors (a model on a mesh) run it on each rank's local heads and
    batch rows (``sharding.local_attention``).
    """
    if sh.is_dtensor(q):
        return sh.local_attention(functools.partial(
            flash_prefill, causal=causal, window=window, kernel=kernel),
            q, k, v)
    b, t, h, dh = q.shape
    if kernel is None:
        if q.device.type != "cuda":
            return attention_any(q, k, v, causal=causal, window=window)
        kernel = _flash_autograd
    if t == 1 or k.shape[1] != t or (window is not None and t > window):
        return attention_any(q, k, v, causal=causal, window=window)
    _fa.compiled_width(dh)

    def heads_first(x):
        x = _expand_kv(x, h).to(COMPUTE_DTYPE)
        return x.permute(0, 2, 1, 3).reshape(b * h, t, dh).contiguous()

    out = kernel(heads_first(q), heads_first(k), heads_first(v),
                 causal=causal)
    return out.reshape(b, h, t, dh).permute(0, 2, 1, 3)


# ---------------------------------------------------------------------- #
# attention block (projections + cache handling)
# ---------------------------------------------------------------------- #
def attn_params(gen, d_model, n_heads, n_kv_heads, head_dim) -> dict:
    return {
        "wq": dense_init(gen, d_model, n_heads * head_dim),
        "wk": dense_init(gen, d_model, n_kv_heads * head_dim),
        "wv": dense_init(gen, d_model, n_kv_heads * head_dim),
        "wo": dense_init(gen, n_heads * head_dim, d_model,
                         scale=1.0 / math.sqrt(n_heads * head_dim)),
    }


def attn_apply(
    p,
    x: torch.Tensor,                  # [B, T, D]
    *,
    n_heads: int,
    n_kv_heads: int,
    head_dim: int,
    rope_theta: float | None,
    causal: bool = True,
    window: int | None = None,
    positions: torch.Tensor | None = None,
    cache: dict | None = None,        # {"k": [B,S,KH,dh], "v":..., "len": int}
    xattn_src: torch.Tensor | None = None,   # cross-attention memory [B, S, D]
) -> tuple[torch.Tensor, dict | None]:
    b, t, d = x.shape
    xc = x.to(COMPUTE_DTYPE)
    q = (xc @ p["wq"].to(COMPUTE_DTYPE)).reshape(b, t, n_heads, head_dim)
    kv_in = xattn_src.to(COMPUTE_DTYPE) if xattn_src is not None else xc
    k = (kv_in @ p["wk"].to(COMPUTE_DTYPE)).reshape(b, -1, n_kv_heads,
                                                    head_dim)
    v = (kv_in @ p["wv"].to(COMPUTE_DTYPE)).reshape(b, -1, n_kv_heads,
                                                    head_dim)

    if positions is None:
        positions = _positions(t, x.device)[None].expand(b, t)
    if rope_theta is not None and xattn_src is None:
        q = rope(q, positions, rope_theta)
        k = rope(k, positions, rope_theta)

    new_cache = None
    if cache is not None and xattn_src is None:
        # decode: append this step's k/v at position cache["len"]
        idx = cache["len"]
        k_all = cache["k"].clone()
        v_all = cache["v"].clone()
        k_all[:, idx:idx + t] = k.to(k_all.dtype)
        v_all[:, idx:idx + t] = v.to(v_all.dtype)
        new_cache = {"k": k_all, "v": v_all, "len": idx + t}
        out = dense_attention(q, k_all, v_all, causal=True, window=window,
                              q_offset=idx)
    else:
        out = attention_any(q, k, v, causal=causal and xattn_src is None,
                            window=window)

    out = out.reshape(b, t, n_heads * head_dim)
    y = out @ p["wo"].to(COMPUTE_DTYPE)
    return y.to(x.dtype), new_cache


def decode_positions(cache_len, b, t, device=None):
    """Positions for cached decode."""
    return cache_len + _positions(t, device)[None].expand(b, t)


# ---------------------------------------------------------------------- #
# MLPs
# ---------------------------------------------------------------------- #
def mlp_params(gen, d_model: int, d_ff: int, gated: bool) -> dict:
    p = {"w_up": dense_init(gen, d_model, d_ff),
         "w_down": dense_init(gen, d_ff, d_model)}
    if gated:
        p["w_gate"] = dense_init(gen, d_model, d_ff)
    return p


def mlp_apply(p, x: torch.Tensor, act: str) -> torch.Tensor:
    """A DTensor ``x`` runs on each rank's local tensors, the hidden units
    split over the mesh dim that shards them and the output's sums pending
    there (``sharding.local_dense``)."""
    if sh.is_dtensor(x):
        names = ("w_up", "w_gate", "w_down") if "w_gate" in p else \
            ("w_up", "w_down")
        return sh.local_dense(
            lambda x, *ws: mlp_apply(dict(zip(names, ws)), x, act),
            x, tuple(p[n] for n in names),
            w_dims=(1, 1, 0)[-len(names):])
    xc = x.to(COMPUTE_DTYPE)
    up = xc @ p["w_up"].to(COMPUTE_DTYPE)
    if "w_gate" in p:
        g = xc @ p["w_gate"].to(COMPUTE_DTYPE)
        g = silu(g) if act == "swiglu" else gelu(g)
        h = g * up
    else:
        h = gelu(up)
    y = h @ p["w_down"].to(COMPUTE_DTYPE)
    return y.to(x.dtype)
