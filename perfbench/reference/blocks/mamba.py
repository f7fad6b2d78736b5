"""Plain fp32 reference of a Mamba-1 layer (as Falcon-Mamba-7B): pre-norm,
an input projection split into x and the gate z, a causal depthwise
convolution and SiLU on x, the selective state space

    h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t,   y_t = C_t . h_t + D x_t,

with dt = softplus(x W_dt_in W_dt + b_dt) and A = -exp(a_log), then
y * silu(z) through the output projection, added to the residual.

Departures from the published Falcon-Mamba-7B, all as the port defines
its model: no RMSNorm on B, C and dt inside the mixer; the norms compute
x / rms(x) * (1 + scale) with eps from the configuration.

The scan is exact and plain: sequential within chunks of :data:`CHUNK`
steps for all chunks at once, then each chunk's entry state carried in;
channels in blocks of :data:`CHANNELS`; its backward is the adjoint
recurrence, run the same way (:class:`Scan`).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from perfbench.reference.common import rmsnorm, silu
from perfbench.weights import Leaf

CHUNK = 64
CHANNELS = 2048


def leaves(cfg: dict) -> list:
    d, i, s, r, k = (cfg[x] for x in ("d_model", "d_inner", "ssm_state",
                                      "dt_rank", "ssm_conv"))
    n = lambda fan_in: ("normal", 1.0 / math.sqrt(fan_in))
    return [Leaf("ln.scale", (d,), ("const", 0.0), False),
            Leaf("mamba.in_proj", (d, 2 * i), n(d), True),
            Leaf("mamba.conv_w", (k, i), n(k), False),
            Leaf("mamba.conv_b", (i,), ("const", 0.0), False),
            Leaf("mamba.x_proj", (i, r + 2 * s), n(i), True),
            Leaf("mamba.dt_proj", (r, i), n(r), True),
            Leaf("mamba.dt_bias", (i,), ("const", -4.6), False),
            Leaf("mamba.a_log", (i, s), ("log_arange",), False),
            Leaf("mamba.d_skip", (i,), ("const", 1.0), False),
            Leaf("mamba.out_proj", (i, d), n(i), True)]


def flops_per_token(cfg: dict, seq_len: int) -> float:
    """No model FLOPs beyond the weights' (the scan is elementwise)."""
    return 0.0


def _states(a: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """h [B, T, I, S] of h_t = a_t h_{t-1} + u_t from h_{-1} = 0 (T a
    multiple of :data:`CHUNK`): each chunk's states from a zero entry, all
    chunks at once, then each chunk's entry state carried in, in order."""
    b, t, i, s = a.shape
    n = t // CHUNK
    a = a.reshape(b, n, CHUNK, i, s)
    u = u.reshape(b, n, CHUNK, i, s)
    h = torch.empty_like(u)
    h[:, :, 0] = u[:, :, 0]
    for j in range(1, CHUNK):
        torch.addcmul(u[:, :, j], a[:, :, j], h[:, :, j - 1], out=h[:, :, j])
    decay = torch.cumprod(a, dim=2)           # a's product from the chunk start
    for c in range(1, n):
        h[:, c] += decay[:, c] * h[:, c - 1, -1:]
    return h.reshape(b, t, i, s)


def _pad(x: torch.Tensor, t: int) -> torch.Tensor:
    return F.pad(x, (0, 0, 0, t - x.shape[1]))     # dt = 0: decay 1, no input


class Scan(torch.autograd.Function):
    """y [B, T, I] of the selective scan for xi, dt [B, T, I], bm, cm
    [B, T, S] and a [I, S], in blocks of :data:`CHANNELS` channels.  The
    backward recomputes the states and runs the adjoint recurrence
    g_t = a_{t+1} g_{t+1} + C_t dy_t backwards in time; then
    da_t = g_t h_{t-1}, du_t = g_t for a_t = exp(dt_t A) and
    u_t = dt_t x_t B_t, and dC_t = sum_i dy_t h_t."""

    @staticmethod
    def forward(ctx, xi, dt, bm, cm, a):
        ctx.save_for_backward(xi, dt, bm, cm, a)
        b, t, i = xi.shape
        tp = -(-t // CHUNK) * CHUNK
        xi, dt, bm, cm = (_pad(x, tp) for x in (xi, dt, bm, cm))
        y = torch.empty((b, tp, i), dtype=xi.dtype, device=xi.device)
        for c in range(0, i, CHANNELS):
            sl = slice(c, c + CHANNELS)
            h = _states(torch.exp(dt[..., sl, None] * a[sl]),
                        (dt[..., sl] * xi[..., sl])[..., None] * bm[:, :, None])
            y[..., sl] = torch.einsum("btis,bts->bti", h, cm)
        return y[:, :t]

    @staticmethod
    def backward(ctx, dy):
        xi, dt, bm, cm, a = ctx.saved_tensors
        b, t, i = xi.shape
        tp = -(-t // CHUNK) * CHUNK
        xi, dt, bm, cm, dy = (_pad(x, tp) for x in (xi, dt, bm, cm, dy))
        dxi, ddt = torch.empty_like(xi), torch.empty_like(dt)
        dbm, dcm = torch.zeros_like(bm), torch.zeros_like(cm)
        da = torch.empty_like(a)
        for c in range(0, i, CHANNELS):
            sl = slice(c, c + CHANNELS)
            dec = torch.exp(dt[..., sl, None] * a[sl])
            dtx = dt[..., sl] * xi[..., sl]
            h = _states(dec, dtx[..., None] * bm[:, :, None])
            nxt = torch.cat([dec[:, 1:], torch.zeros_like(dec[:, :1])], dim=1)
            g = _states(nxt.flip(1), (dy[..., sl, None] * cm[:, :, None])
                        .flip(1)).flip(1)
            dcm += torch.einsum("bti,btis->bts", dy[..., sl], h)
            h = torch.cat([torch.zeros_like(h[:, :1]), h[:, :-1]], dim=1)
            gd = g * h * dec                      # d(decay) * decay
            del h, nxt
            gb = torch.einsum("btis,bts->bti", g, bm)
            ddt[..., sl] = torch.einsum("btis,is->bti", gd, a[sl]) \
                + gb * xi[..., sl]
            da[sl] = torch.einsum("btis,bti->is", gd, dt[..., sl])
            dxi[..., sl] = gb * dt[..., sl]
            dbm += torch.einsum("btis,bti->bts", g, dtx)
        return dxi[:, :t], ddt[:, :t], dbm[:, :t], dcm[:, :t], da


def apply(p: dict, x: torch.Tensor, cfg: dict, prec) -> torch.Tensor:
    if cfg.get("mixer_norms"):
        raise ValueError("the reference has no RMSNorm of B, C and dt")
    r, s = cfg["dt_rank"], cfg["ssm_state"]
    h = prec(rmsnorm(x, p["ln.scale"], cfg["norm_eps"]))
    xi, z = torch.chunk(torch.matmul(h, prec(p["mamba.in_proj"])), 2, dim=-1)
    w, k = p["mamba.conv_w"], p["mamba.conv_w"].shape[0]
    xp = F.pad(xi, (0, 0, k - 1, 0))                       # causal
    t = xi.shape[1]
    xi = silu(sum(xp[:, j:j + t] * w[j] for j in range(k)) + p["mamba.conv_b"])
    dt_in, bm, cm = torch.split(torch.matmul(prec(xi), prec(p["mamba.x_proj"])),
                                [r, s, s], dim=-1)
    # dt's projection is fp32 in the configuration too: no rounding
    dt = F.softplus(torch.matmul(dt_in, p["mamba.dt_proj"]) + p["mamba.dt_bias"])
    y = Scan.apply(xi, dt, bm, cm, -torch.exp(p["mamba.a_log"]))
    y = (y + xi * p["mamba.d_skip"]) * silu(z)
    return x + torch.matmul(prec(y), prec(p["mamba.out_proj"]))
