"""Multi-head latent attention (MLA, DeepSeek-V2) with YaRN rope scaling.

For the normed input x [B, T, D] and H heads:

    q        = x W_q                       [B, T, H, dn + dr]
    [c, k_r] = x W_kva                     c [B, T, dc], k_r [B, T, dr]
    [k_n, v] = N_kv(c) W_kvb               [B, T, H, dn + dv]
    o        = softmax(m^2 [q_n, R q_r] [k_n, R k_r]^T / sqrt(dn + dr),
                       causal) v
    y        = o W_o

with N_kv the latent's RMSNorm, R the rotary embedding at YaRN's inverse
frequencies (:func:`yarn_inv_freq`) and k_r shared by every head.  m is
YaRN's attention scale (:func:`softmax_mscale`), folded into q before its
bf16 cast; YaRN's factor on cos and sin, mscale over mscale_all_dim, is 1
for DeepSeek-V2 (the two are equal), and the configuration holds one.  Rotation turns the two halves of the rope part together, as
``layers.rope`` does (DeepSeek's code rotates adjacent pairs: the same map
after a permutation of W_q's and W_kva's rope columns).

Attention runs through the model's ``attention`` function (on the card the
``flash_attention`` kernel and its backward): q and k are dn + dr wide and
v is padded with zeros to that width, its output columns sliced back to
dv.  Serving MLA (its latent cache) is not implemented.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import (COMPUTE_DTYPE, flash_prefill, normal,
                                       rmsnorm)
from repro_torch.obs.trace import span


def mla_params(gen, cfg: ArchConfig) -> dict:
    """W_q [D, H, dn+dr], W_kva [D, dc+dr], the latent norm's scale [dc],
    W_kvb [dc, H, dn+dv], W_o [H, dv, D]."""
    d, h, dc = cfg.d_model, cfg.n_heads, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    dev = gen.device
    return {
        "wq": normal(gen, (d, h, dn + dr), 1.0 / math.sqrt(d)),
        "wkv_a": normal(gen, (d, dc + dr), 1.0 / math.sqrt(d)),
        "kv_norm": torch.zeros((dc,), dtype=torch.float32, device=dev),
        "wkv_b": normal(gen, (dc, h, dn + dv), 1.0 / math.sqrt(dc)),
        "wo": normal(gen, (h, dv, d), 1.0 / math.sqrt(h * dv)),
    }


def softmax_mscale(cfg: ArchConfig) -> float:
    """m = 0.1 mscale ln(factor) + 1 (1 without YaRN), with the scores
    scaled by m^2 / sqrt(dn + dr)."""
    if cfg.yarn_factor <= 1:
        return 1.0
    return 0.1 * cfg.yarn_mscale * math.log(cfg.yarn_factor) + 1.0


@functools.cache
def yarn_inv_freq(cfg: ArchConfig, device=None) -> torch.Tensor:
    """The rope part's inverse frequencies [dr / 2] (fp32, worked out in
    fp64): f_i = theta^(-2i/dr); with YaRN, f_i / s r_i + f_i (1 - r_i)
    where r_i ramps from 0 to 1 between the dims whose wavelengths turn
    beta_fast and beta_slow times over the original context.  Kept per
    (configuration, device): every layer and step reads the same."""
    dr, theta = cfg.qk_rope_head_dim, cfg.rope_theta
    i = torch.arange(dr // 2, dtype=torch.float64, device=device)
    f = theta ** (-2.0 * i / dr)
    if cfg.yarn_factor > 1:
        dim = lambda rot: dr * math.log(
            cfg.yarn_original_len / (rot * 2 * math.pi)) / (2 * math.log(theta))
        low = max(math.floor(dim(cfg.yarn_beta_fast)), 0)
        high = min(math.ceil(dim(cfg.yarn_beta_slow)), dr - 1)
        ramp = torch.clamp((i - low) / max(high - low, 1e-3), 0.0, 1.0)
        f = f / cfg.yarn_factor * ramp + f * (1.0 - ramp)
    return f.float()


def rope(x: torch.Tensor, positions: torch.Tensor,
         inv_freq: torch.Tensor) -> torch.Tensor:
    """x [B, T, H, dr] rotated at ``positions`` [B, T], the two halves
    together, in fp32, so that the caller scales q before its one bf16
    cast (``layers.rope`` returns x's dtype)."""
    half = x.shape[-1] // 2
    ang = positions[..., None].float() * inv_freq           # [B, T, half]
    cos, sin = torch.cos(ang)[:, :, None], torch.sin(ang)[:, :, None]
    xf = x.float()
    x1, x2 = xf[..., :half], xf[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def mla_attention(p, x: torch.Tensor, cfg: ArchConfig, *,
                  attention=flash_prefill) -> torch.Tensor:
    """Causal MLA of the normed input x [B, T, D] (bf16), its output
    projected back to [B, T, D]."""
    b, t, _ = x.shape
    h, dc = cfg.n_heads, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    cd = COMPUTE_DTYPE
    with span("mla.project"):
        xc = x.to(cd)
        q = torch.einsum("btd,dhk->bthk", xc, p["wq"].to(cd))
        kv_a = xc @ p["wkv_a"].to(cd)                       # [B, T, dc+dr]
        c = rmsnorm({"scale": p["kv_norm"]}, kv_a[..., :dc])
        kv = torch.einsum("btc,chk->bthk", c.to(cd), p["wkv_b"].to(cd))
        pos = torch.arange(t, device=x.device)[None].expand(b, t)
        inv = yarn_inv_freq(cfg, x.device)
        q = torch.cat([q[..., :dn].float(), rope(q[..., dn:], pos, inv)],
                      dim=-1)
        q = (q * softmax_mscale(cfg) ** 2).to(cd)
        k_r = rope(kv_a[..., None, dc:], pos, inv).to(cd)
        k = torch.cat([kv[..., :dn], k_r.expand(b, t, h, dr)], dim=-1)
        v = F.pad(kv[..., dn:], (0, dn + dr - dv))
    with span("mla.attention"):
        o = attention(q, k, v, causal=True, window=None)[..., :dv]
        return torch.einsum("bthk,hkd->btd", o.to(cd), p["wo"].to(cd))
