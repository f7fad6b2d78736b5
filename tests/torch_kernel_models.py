"""CPU models of the hand-written kernels' arithmetic, shared by the tests.

``kernel_model`` repeats the bf16 route of ``csrc/flash_attention.cu``:
q tiles of bq rows, the softmax in steps of bk keys (64 with bq = 128,
where the kernel's two consumer warpgroups split a kv tile into 64-key
steps; steps past S or wholly above the causal diagonal skipped), scores
from bf16 inputs summed in fp32, scale and masks in log2 units, a running
max and an fp32 denominator per row, P split into bf16 hi + lo parts for
P V with an fp32 accumulator, out = acc / max(l, 1e-30) rounded to bf16.

``group_scan`` repeats ``csrc/selective_scan.cu``'s order: a group of G
lanes per (batch row, channel), G = S rounded up to a power of two, lane s
holding state s and its product h[s] * C[t, s] (0 past S), y_t the
group's butterfly (the partial of the lane G/2 away, then G/4, ..., 1),
time in order with no carry between chunks but h itself.

``bwd_kernel_model`` repeats ``csrc/flash_attention_bwd.cu``: S = Q K^T
and dP = dO V^T summed in fp32 from bf16 inputs, P = exp2(S scale log2e
- lse log2e) (0 where masked or past T / S), D = rowsum(P dP) in fp32
over the kv tiles in order, dS = P (dP - D), then P rounded to bf16 and
dS split into bf16 hi + lo parts as the operands of dV = P^T dO, dK =
scale dS^T Q and dQ = scale dS K, each summed in fp32 over 64-row tiles
in order and rounded to bf16 once.
"""
import math

import torch

NEG_INF = -1e30
LOG2E = 1.4426950408889634


def kernel_model(q, k, v, *, causal, bq, bk, split=True):
    """The bf16 kernel's arithmetic; q [BH, T, d], k, v [BH, S, d] bf16."""
    f = torch.float32
    bh, t, d = q.shape
    s_len = k.shape[1]
    q32, k32, v32 = q.to(f), k.to(f), v.to(f)
    scale = torch.tensor(1.0 / math.sqrt(d) * LOG2E, dtype=f)
    out = torch.empty((bh, t, d), dtype=f)
    for q0 in range(0, t, bq):
        qs = q32[:, q0:q0 + bq]
        qpos = torch.arange(q0, q0 + qs.shape[1])[:, None]
        m = torch.full((bh, qs.shape[1]), NEG_INF, dtype=f)
        l = torch.zeros((bh, qs.shape[1]), dtype=f)
        acc = torch.zeros((bh, qs.shape[1], d), dtype=f)
        step = 64 if bq == 128 else bk
        n_steps = -(-s_len // step)
        if causal:
            n_steps = min(n_steps, (q0 + bq - 1) // step + 1)
        for kv0 in range(0, n_steps * step, step):
            ks, vs = k32[:, kv0:kv0 + step], v32[:, kv0:kv0 + step]
            kpos = torch.arange(kv0, kv0 + ks.shape[1])[None, :]
            keep = kpos < s_len
            if causal:
                keep = keep & (kpos <= qpos)
            sc = torch.where(keep, (qs @ ks.transpose(1, 2)) * scale,
                             torch.tensor(NEG_INF, dtype=f))
            m_new = torch.maximum(m, sc.max(-1).values)
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(sc - m_new[..., None])
            l = l * alpha + p.sum(-1)
            hi = p.to(torch.bfloat16).to(f)
            pv = hi @ vs
            if split:
                pv = pv + (p - hi).to(torch.bfloat16).to(f) @ vs
            acc = acc * alpha[..., None] + pv
            m = m_new
        out[:, q0:q0 + bq] = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.to(q.dtype)



def _bf16_parts(x, split):
    """x as the kernel's bf16 wgmma operand(s): one rounding, or hi + lo."""
    hi = x.to(torch.bfloat16).to(torch.float32)
    return [hi, (x - hi).to(torch.bfloat16).to(torch.float32)] if split \
        else [hi]


def bwd_kernel_model(q, k, v, do, *, causal, bq=64, bk=64, split=True,
                     d_from_out=False):
    """The backward kernel's arithmetic: (dq, dk, dv) bf16 of q, do
    [BH, T, d] and k, v [BH, S, d] bf16, P from the plain log-sum-exp.
    ``split=False`` rounds dS to bf16 once instead of splitting it into
    hi + lo parts; ``d_from_out`` takes D = rowsum(dO o) from the bf16
    output o instead of rowsum(P dP), as the first version did."""
    from repro_torch.kernels import ref
    f = torch.float32
    bh, t, d = q.shape
    s_len = k.shape[1]
    q32, k32, v32, do32 = (x.to(f) for x in (q, k, v, do))
    scale = 1.0 / math.sqrt(d)
    lse2 = ref.attention_lse_ref(q, k, causal=causal) * LOG2E
    qpos = torch.arange(t)[:, None]
    kpos = torch.arange(s_len)[None, :]
    keep = kpos < s_len
    if causal:
        keep = keep & (kpos <= qpos)
    sc = q32 @ k32.transpose(1, 2)
    p = torch.where(keep, torch.exp2(sc * (scale * LOG2E) - lse2[..., None]),
                    torch.zeros((), dtype=f))
    dp = do32 @ v32.transpose(1, 2)
    if d_from_out:
        o = ref.attention_ref(q, k, v, causal=causal)
        dsum = (do32 * o.to(f)).sum(-1)
    else:
        dsum = torch.zeros((bh, t), dtype=f)
        for k0 in range(0, s_len, bk):            # the dq pass's first sweep
            dsum = dsum + (p[..., k0:k0 + bk] * dp[..., k0:k0 + bk]).sum(-1)
    ds = p * (dp - dsum[..., None])
    p_parts, ds_parts = _bf16_parts(p, False), _bf16_parts(ds, split)
    dq = torch.zeros((bh, t, d), dtype=f)
    for k0 in range(0, s_len, bk):                # the dq pass's second sweep
        for part in ds_parts:
            dq = dq + part[..., k0:k0 + bk] @ k32[:, k0:k0 + bk]
    dk = torch.zeros((bh, s_len, d), dtype=f)
    dv = torch.zeros((bh, s_len, d), dtype=f)
    for q0 in range(0, t, bq):                    # the dk / dv pass
        for part in p_parts:
            dv = dv + part[:, q0:q0 + bq].transpose(1, 2) @ do32[:, q0:q0 + bq]
        for part in ds_parts:
            dk = dk + part[:, q0:q0 + bq].transpose(1, 2) @ q32[:, q0:q0 + bq]
    bf = torch.bfloat16
    return (dq * scale).to(bf), (dk * scale).to(bf), dv.to(bf)


def peaked(q, k, *, causal, peak=0.99):
    """q (bf16) scaled by 2^(1/4) steps until the largest P = softmax(q
    k^T / sqrt(d)) of the tensor reaches ``peak``: rows that one key
    dominates, where the backward's dP - D cancels."""
    from repro_torch.kernels import ref
    t, s_len = q.shape[1], k.shape[1]
    for _ in range(64):
        lse = ref.attention_lse_ref(q, k, causal=causal)
        sc = q.float() @ k.float().transpose(1, 2) / math.sqrt(q.shape[-1])
        if causal:
            keep = torch.arange(s_len, device=q.device)[None, :] <= \
                torch.arange(t, device=q.device)[:, None]
            sc = torch.where(keep, sc, torch.full_like(sc, NEG_INF))
        if float(torch.exp(sc - lse[..., None]).max()) >= peak:
            return q
        q = (q.float() * 2 ** 0.25).bfloat16()
    raise ValueError(f"q did not reach a largest P of {peak}")


def group_lanes(s: int) -> int:
    """Lanes per channel the kernel takes for ``s`` states: S rounded up
    to a power of two."""
    g = 1
    while g < s:
        g *= 2
    return g


def group_scan(xi, dt, bmat, cmat, a, h0):
    """The kernel's recurrence and y reduction in fp32: (y [B, T, I] in
    xi's dtype, h_last [B, I, S] fp32)."""
    f = torch.float32
    t_len, s = xi.shape[1], a.shape[1]
    g = group_lanes(s)
    pad = lambda x: torch.nn.functional.pad(x.to(f), (0, g - s))
    h, av = pad(h0), pad(a)                       # idle states stay 0
    xi32, dt32 = xi.to(f), dt.to(f)
    b32, c32 = pad(bmat), pad(cmat)
    lanes = torch.arange(g)
    ys = []
    for t in range(t_len):
        dtv = dt32[:, t, :, None]
        dtx = dtv * xi32[:, t, :, None]
        da = torch.exp(dtv * av[None])
        h = da * h + dtx * b32[:, t, None, :]
        acc = h * c32[:, t, None, :]              # one product per lane
        off = g // 2
        while off:                                # the group's butterfly
            acc = acc + acc[..., lanes ^ off]
            off //= 2
        ys.append(acc[..., 0])
    y = torch.stack(ys, dim=1) if ys else torch.zeros_like(xi32)
    return y.to(xi.dtype), h[..., :s].contiguous()
