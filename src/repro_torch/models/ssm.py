"""State-space blocks: Mamba-1 (selective scan) and RG-LRU (RecurrentGemma),
the reference's ``models/ssm.py`` in PyTorch.

Both are linear recurrences h_t = a_t * h_{t-1} + b_t.  The plain twins
evaluate them as the reference does: a loop over chunks carrying the
boundary state, each chunk by the same associative-scan tree as
``jax.lax.associative_scan`` (:func:`associative_scan`).  On the card
every Mamba scan goes through the hand-written ``selective_scan`` kernel
(:func:`kernel_scan`); ``mamba_apply`` takes its scan function.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models import sharding as sh
from repro_torch.models.layers import (COMPUTE_DTYPE, dense_init, gelu, normal,
                                       sigmoid, silu, softplus)


# ---------------------------------------------------------------------- #
# chunked linear scan: h_t = a_t * h_{t-1} + b_t
# ---------------------------------------------------------------------- #
def _assoc(e1, e2):
    a1, b1 = e1
    a2, b2 = e2
    return a2 * a1, a2 * b1 + b2


def _interleave(a: torch.Tensor, b: torch.Tensor, dim: int) -> torch.Tensor:
    n = a.shape[dim] + b.shape[dim]
    out = a.new_empty(a.shape[:dim] + (n,) + a.shape[dim + 1:])
    idx = [slice(None)] * a.dim()
    idx[dim] = slice(0, None, 2)
    out[tuple(idx)] = a
    idx[dim] = slice(1, None, 2)
    out[tuple(idx)] = b
    return out


def associative_scan(fn, elems: tuple, dim: int = 0) -> tuple:
    """Inclusive scan of the tuple ``elems`` along ``dim`` with the
    associative ``fn``, by ``jax.lax.associative_scan``'s tree (pairs
    combined, the odd positions scanned recursively, the even ones filled
    in), so the products and sums are taken in its order."""
    def sl(x, start, stop=None, step=1):
        idx = [slice(None)] * x.dim()
        idx[dim] = slice(start, stop, step)
        return x[tuple(idx)]

    n = elems[0].shape[dim]
    if n < 2:
        return elems
    reduced = fn(tuple(sl(e, 0, -1, 2) for e in elems),
                 tuple(sl(e, 1, None, 2) for e in elems))
    odd = associative_scan(fn, reduced, dim)
    if n % 2 == 0:
        even = fn(tuple(sl(e, 0, -1) for e in odd),
                  tuple(sl(e, 2, None, 2) for e in elems))
    else:
        even = fn(odd, tuple(sl(e, 2, None, 2) for e in elems))
    even = tuple(torch.cat([sl(e, 0, 1), r], dim=dim)
                 for e, r in zip(elems, even))
    return tuple(_interleave(e, o, dim) for e, o in zip(even, odd))


def linear_scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor,
                chunk: int = 256) -> torch.Tensor:
    """a, b: [T, ...] coefficients; h0: [...] initial state.
    Returns h: [T, ...] (all states)."""
    t = a.shape[0]
    if t <= 4:
        # decode fast path: unrolled recurrence, no chunk padding
        hs = []
        h = h0
        for i in range(t):
            h = a[i] * h + b[i]
            hs.append(h)
        return torch.stack(hs)
    pad = (-t) % chunk
    if pad:
        a = torch.cat([a, a.new_ones((pad,) + a.shape[1:])])
        b = torch.cat([b, b.new_zeros((pad,) + b.shape[1:])])
    h = h0
    out = []
    for c0 in range(0, a.shape[0], chunk):
        a_i, b_i = a[c0:c0 + chunk], b[c0:c0 + chunk]
        # fold carry into the first element, then scan the chunk
        b0 = torch.cat([(b_i[0] + a_i[0] * h)[None], b_i[1:]])
        _aa, bb = associative_scan(_assoc, (a_i, b0), 0)
        h = bb[-1]
        out.append(bb)
    return torch.cat(out)[:t]


# ---------------------------------------------------------------------- #
# Mamba-1
# ---------------------------------------------------------------------- #
def mamba_params(gen, d_model: int, d_inner: int, d_state: int,
                 dt_rank: int, conv_width: int = 4) -> dict:
    dev = gen.device
    return {
        "in_proj": dense_init(gen, d_model, 2 * d_inner),
        "conv_w": normal(gen, (conv_width, d_inner),
                         1.0 / math.sqrt(conv_width)),
        "conv_b": torch.zeros((d_inner,), dtype=torch.float32, device=dev),
        "x_proj": dense_init(gen, d_inner, dt_rank + 2 * d_state),
        "dt_proj": dense_init(gen, dt_rank, d_inner),
        "dt_bias": torch.full((d_inner,), -4.6, dtype=torch.float32,
                              device=dev),                # softplus ~ 0.01
        "a_log": torch.log(torch.arange(
            1, d_state + 1, dtype=torch.float32, device=dev)[None]
            .repeat(d_inner, 1)),
        "d_skip": torch.ones((d_inner,), dtype=torch.float32, device=dev),
        "out_proj": dense_init(gen, d_inner, d_model),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: torch.Tensor | None = None):
    """Depthwise causal conv1d.  x: [B, T, C]; w: [K, C].
    Returns (y [B, T, C], new_state [B, K-1, C])."""
    kw = w.shape[0]
    if state is None:
        state = x.new_zeros((x.shape[0], kw - 1, x.shape[2]))
    xx = torch.cat([state, x], dim=1)
    t = x.shape[1]
    y = sum(xx[:, i: i + t] * w[i][None, None] for i in range(kw))
    # a copy, not a view: a cache must not keep all of ``xx`` alive
    new_state = xx[:, -(kw - 1):].clone() if kw > 1 else state
    return y + b[None, None], new_state


def selective_scan_fused(xi, dt, bmat, cmat, a, h0, chunk: int):
    """Chunk-fused selective scan: the coefficients are computed inside
    each chunk, so only [B, chunk, I, S] is ever materialized.

    xi, dt: [B, T, I]; bmat, cmat: [B, T, S]; a: [I, S]; h0: [B, I, S].
    Returns (y [B, T, I], h_last [B, I, S]).
    """
    b, t, i = xi.shape
    pad = (-t) % chunk
    if pad:
        z = lambda x_: F.pad(x_, (0, 0, 0, pad))   # dt=0: da=1, dbx=0
        xi, dt, bmat, cmat = z(xi), z(dt), z(bmat), z(cmat)
    h = h0
    ys = []
    for c0 in range(0, xi.shape[1], chunk):
        sl = slice(c0, c0 + chunk)
        xi_c, dt_c, b_c, c_c = xi[:, sl], dt[:, sl], bmat[:, sl], cmat[:, sl]
        da = torch.exp(dt_c[..., None] * a[None, None])       # [B,c,I,S]
        dbx = (dt_c * xi_c)[..., None] * b_c[:, :, None, :]
        dbx = torch.cat([(dbx[:, 0] + da[:, 0] * h)[:, None], dbx[:, 1:]],
                        dim=1)
        _aa, hh = associative_scan(_assoc, (da, dbx), 1)
        ys.append(torch.einsum("bcis,bcs->bci", hh, c_c))
        h = hh[:, -1]
    return torch.cat(ys, dim=1)[:, :t], h.clone()


def plain_scan(xi, dt, bmat, cmat, a, h0, *, chunk: int = 256,
               fused: bool = False):
    """The Mamba-1 scan by the reference's branches (``ssm.py:165-174``):
    :func:`selective_scan_fused` when ``fused`` and T > 4, else the
    materialized coefficients through :func:`linear_scan`.  Returns
    (y [B, T, I], h_last [B, I, S])."""
    if fused and xi.shape[1] > 4:
        return selective_scan_fused(xi, dt, bmat, cmat, a, h0, chunk)
    da = torch.exp(dt[..., None] * a[None, None])            # [B, T, I, S]
    dbx = (dt * xi)[..., None] * bmat[:, :, None, :]          # [B, T, I, S]
    # linear_scan is time-major; the batch rides along as a state axis
    hs = linear_scan(da.transpose(0, 1), dbx.transpose(0, 1), h0,
                     chunk=chunk).transpose(0, 1)
    y = torch.einsum("btis,bts->bti", hs, cmat)               # C_t . h_t
    return y, hs[:, -1].clone()             # not a view that keeps hs alive


def kernel_scan(xi, dt, bmat, cmat, a, h0, *, chunk: int = 256,
                fused: bool = False, kernel=None):
    """The Mamba-1 scan through the ``selective_scan`` kernel (every T,
    decode's T = 1 included), fp32, contiguous operands.  ``kernel`` has
    ``ops.selective_scan``'s signature; left as None it is the
    differentiable ``ops.SelectiveScan`` (the forward kernel, and the
    backward kernel when a gradient is taken) for CUDA tensors, and for
    CPU tensors the whole call is :func:`plain_scan` (``chunk`` and
    ``fused`` matter only there).  DTensors (a model on a mesh) run it on
    each rank's local batch rows and channels (``sharding.local_scan``)."""
    if sh.is_dtensor(xi):
        return sh.local_scan(functools.partial(
            kernel_scan, chunk=chunk, fused=fused, kernel=kernel),
            xi, dt, bmat, cmat, a, h0)
    if kernel is None:
        if xi.device.type != "cuda":
            return plain_scan(xi, dt, bmat, cmat, a, h0, chunk=chunk,
                              fused=fused)
        kernel = ops.SelectiveScan.apply
    return kernel(*(x.float().contiguous()
                    for x in (xi, dt, bmat, cmat, a, h0)))


def mamba_apply(
    p,
    x: torch.Tensor,               # [B, T, D]
    *,
    d_state: int,
    dt_rank: int,
    cache: dict | None = None,     # {"conv": [B,K-1,I], "ssm": [B,I,S]}
    chunk: int = 256,
    fused: bool = False,
    scan=kernel_scan,
) -> tuple[torch.Tensor, dict | None]:
    """One Mamba-1 mixer; ``scan`` has :func:`plain_scan`'s signature (the
    default, :func:`kernel_scan`, is the kernel on the card)."""
    b, t, d = x.shape
    xc = x.to(COMPUTE_DTYPE)
    xz = xc @ p["in_proj"].to(COMPUTE_DTYPE)
    xi, z = torch.chunk(xz, 2, dim=-1)                        # [B, T, I]
    d_inner = xi.shape[-1]

    conv_state = cache["conv"] if cache else None
    xi, new_conv = _causal_conv(xi.float(), p["conv_w"], p["conv_b"],
                                conv_state)
    xi = silu(xi)

    proj = xi.to(COMPUTE_DTYPE) @ p["x_proj"].to(COMPUTE_DTYPE)
    dt_in, bmat, cmat = torch.split(proj.float(),
                                    [dt_rank, d_state, d_state], dim=-1)
    dt = softplus(dt_in @ p["dt_proj"].float()
                    + p["dt_bias"][None, None])               # [B, T, I]
    a = -torch.exp(p["a_log"])                                # [I, S]

    h0 = cache["ssm"] if cache else x.new_zeros(
        (b, d_inner, d_state), dtype=torch.float32)
    y, h_last = scan(xi, dt, bmat, cmat, a, h0, chunk=chunk, fused=fused)
    y = y + xi * p["d_skip"][None, None]
    y = y * silu(z.float())
    out = y.to(COMPUTE_DTYPE) @ p["out_proj"].to(COMPUTE_DTYPE)

    new_cache = None
    if cache is not None:
        new_cache = {"conv": new_conv.to(cache["conv"].dtype),
                     "ssm": h_last.to(cache["ssm"].dtype)}
    return out.to(x.dtype), new_cache


# ---------------------------------------------------------------------- #
# RG-LRU (RecurrentGemma recurrent block)
# ---------------------------------------------------------------------- #
def rglru_params(gen, d_model: int, d_inner: int, conv_width: int = 4) -> dict:
    dev = gen.device
    return {
        "in_proj": dense_init(gen, d_model, 2 * d_inner),
        "conv_w": normal(gen, (conv_width, d_inner),
                         1.0 / math.sqrt(conv_width)),
        "conv_b": torch.zeros((d_inner,), dtype=torch.float32, device=dev),
        "w_a": dense_init(gen, d_inner, d_inner),     # recurrence gate
        "w_i": dense_init(gen, d_inner, d_inner),     # input gate
        "lambda_p": torch.full((d_inner,), 2.0, dtype=torch.float32,
                               device=dev),
        "out_proj": dense_init(gen, d_inner, d_model),
    }


RGLRU_C = 8.0


def rglru_apply(
    p,
    x: torch.Tensor,               # [B, T, D]
    *,
    cache: dict | None = None,     # {"conv": [B,K-1,I], "h": [B,I]}
    chunk: int = 256,
) -> tuple[torch.Tensor, dict | None]:
    b, t, d = x.shape
    xc = x.to(COMPUTE_DTYPE)
    xz = xc @ p["in_proj"].to(COMPUTE_DTYPE)
    xi, z = torch.chunk(xz, 2, dim=-1)

    conv_state = cache["conv"] if cache else None
    xi, new_conv = _causal_conv(xi.float(), p["conv_w"], p["conv_b"],
                                conv_state)

    xb = xi.to(COMPUTE_DTYPE)
    r = sigmoid(xb @ p["w_a"].to(COMPUTE_DTYPE))
    i_g = sigmoid(xb @ p["w_i"].to(COMPUTE_DTYPE))
    log_a = -RGLRU_C * softplus(p["lambda_p"])[None, None] * r.float()
    a = torch.exp(log_a)                                      # [B, T, I]
    gated_x = xi * i_g.float()
    bterm = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * gated_x

    h0 = cache["h"] if cache else x.new_zeros((b, xi.shape[-1]),
                                              dtype=torch.float32)
    hs = linear_scan(a.transpose(0, 1), bterm.transpose(0, 1), h0,
                     chunk=chunk).transpose(0, 1)

    y = hs * gelu(z.float())
    out = y.to(COMPUTE_DTYPE) @ p["out_proj"].to(COMPUTE_DTYPE)
    new_cache = None
    if cache is not None:
        new_cache = {"conv": new_conv.to(cache["conv"].dtype),
                     "h": hs[:, -1].to(cache["h"].dtype).clone()}
    return out.to(x.dtype), new_cache
