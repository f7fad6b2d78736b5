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

Both attention models take ``width``: the kernels' compiled head width
(64, 128 or 256) that runs a narrower ``d``.  The inputs are then padded
with zero columns to it, as TMA's out-of-range fill pads the kernels'
tiles, the arithmetic runs at that width with the scale of ``d``, and the
outputs keep their first ``d`` columns.

``chunk_scan_bwd`` repeats ``csrc/selective_scan_bwd.cu``'s chunk-parallel
order: per chunk of ``chunk`` steps the local forward state (from a zero
entry state), the local reverse state (from a zero incoming g) and the sum
of dt; a walk over the chunks for each chunk's entry state and incoming g
(the chunk's map is 2^(a log2(e) sum dt) x + local); then per chunk h_t
recomputed from its entry state and the reverse recurrence from its
incoming g, each lane's part of da summed over the chunk, the parts added
over b, then the chunks.  Every da is 2^(dt a log2(e)), as the kernel
takes it (ex2); the sums over s and over channels are torch's.

``tf32_matmul_model`` and ``tf32_attention_model`` repeat the fp32 routes
of ``csrc/cim_matmul.cu`` and ``csrc/flash_attention.cu`` (3xTF32 on the
tensor cores): every operand split by ``tf32_parts`` into hi = tf32(x) and
lo = tf32(x - hi) (to nearest, ties away from zero), each k8 step of a
product adding lo_a hi_b, then hi_a lo_b, then hi_a hi_b
(one step's eight products are exact in fp32 and summed there).  The
matmul sums each 32-wide K stage's hi_a hi_b steps apart and adds that to
the tile's sum, the small terms into one sum per K block, added last; AF
keeps one block, PF a fresh one per bk-wide K block, added to the fp32
output block after block.
The attention runs the bf16 route's softmax (log2 units, running max,
steps past S or above the causal diagonal change nothing) in steps of 64
keys at compiled widths 64 and 128 and 32 at 256, S = Q K^T over d in k8 steps and
P V over the step's keys in k8 steps.  ``single=True`` keeps hi_a hi_b
alone: one tf32 product, which the fp32 tolerance does not admit.
"""
import math

import torch

NEG_INF = -1e30
LOG2E = 1.4426950408889634


def _pad_cols(width, *xs):
    """``xs`` with zero columns appended up to ``width`` (None: as they
    are)."""
    if width is None:
        return xs
    if width < xs[0].shape[-1]:
        raise ValueError(f"width {width} is narrower than {xs[0].shape[-1]}")
    return tuple(torch.nn.functional.pad(x, (0, width - x.shape[-1]))
                 for x in xs)


def kernel_model(q, k, v, *, causal, bq, bk, split=True, width=None):
    """The bf16 kernel's arithmetic; q [BH, T, d], k, v [BH, S, d] bf16;
    with ``width``, run at that compiled width on zero-padded columns."""
    f = torch.float32
    d_out = q.shape[-1]
    scale = torch.tensor(1.0 / math.sqrt(d_out) * LOG2E, dtype=f)
    q, k, v = _pad_cols(width, q, k, v)
    bh, t, d = q.shape
    s_len = k.shape[1]
    q32, k32, v32 = q.to(f), k.to(f), v.to(f)
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
    return out[..., :d_out].to(q.dtype)



def _bf16_parts(x, split):
    """x as the kernel's bf16 wgmma operand(s): one rounding, or hi + lo."""
    hi = x.to(torch.bfloat16).to(torch.float32)
    return [hi, (x - hi).to(torch.bfloat16).to(torch.float32)] if split \
        else [hi]


def bwd_kernel_model(q, k, v, do, *, causal, bq=64, bk=64, split=True,
                     d_from_out=False, width=None):
    """The backward kernel's arithmetic: (dq, dk, dv) bf16 of q, do
    [BH, T, d] and k, v [BH, S, d] bf16, P from the plain log-sum-exp.
    ``split=False`` rounds dS to bf16 once instead of splitting it into
    hi + lo parts; ``d_from_out`` takes D = rowsum(dO o) from the bf16
    output o instead of rowsum(P dP), as the first version did; with
    ``width``, run at that compiled width on zero-padded columns."""
    from repro_torch.kernels import ref
    f = torch.float32
    d_out = q.shape[-1]
    scale = 1.0 / math.sqrt(d_out)
    lse2 = ref.attention_lse_ref(q, k, causal=causal) * LOG2E
    if d_from_out:
        o = ref.attention_ref(q, k, v, causal=causal)
    q, k, v, do = _pad_cols(width, q, k, v, do)
    bh, t, d = q.shape
    s_len = k.shape[1]
    q32, k32, v32, do32 = (x.to(f) for x in (q, k, v, do))
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
        dsum = (do32[..., :d_out] * o.to(f)).sum(-1)
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
    return tuple(x[..., :d_out].to(bf)
                 for x in (dq * scale, dk * scale, dv))


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


def chunk_scan_bwd(xi, dt, bmat, cmat, a, h0, dy, dh_last, *, chunk=32):
    """The chunk-parallel backward kernel's arithmetic in fp32: (dxi, ddt,
    dB, dC, da, dh0) of the scan against ``dy`` and ``dh_last``."""
    f = torch.float32
    xi, dt, bm, cm, a, h0, dy, dhl = (x.to(f) for x in (
        xi, dt, bmat, cmat, a, h0, dy, dh_last))
    b_len, t_len, i_len = xi.shape
    a2 = a * torch.tensor(LOG2E, dtype=f)
    n_ch = -(-t_len // chunk)
    spans = [(c * chunk, min(chunk, t_len - c * chunk)) for c in range(n_ch)]
    col = lambda x, t: x[:, t, :, None]           # [B, I, 1]
    row = lambda x, t: x[:, t, None, :]           # [B, 1, S]
    step = lambda h, t: torch.exp2(col(dt, t) * a2) * h + \
        col(dt, t) * col(xi, t) * row(bm, t)
    # 1. each chunk's local states and sum of dt
    u, w, sdt = [], [], []
    for t0, n in spans:
        h = torch.zeros_like(h0)
        g = torch.zeros_like(h0)
        sd = torch.zeros((b_len, i_len), dtype=f)
        for k in range(n):
            tr = t0 + n - 1 - k
            h = step(h, t0 + k)
            sd = sd + dt[:, t0 + k]
            g = (g + col(dy, tr) * row(cm, tr)) * torch.exp2(col(dt, tr) * a2)
        u.append(h)
        w.append(g)
        sdt.append(sd)
    # 2. the walk over the chunks
    decay = [torch.exp2(a2 * sd[..., None]) for sd in sdt]
    h_in, g_in = [None] * n_ch, [None] * n_ch
    h = h0
    for c in range(n_ch):
        h_in[c] = h
        h = decay[c] * h + u[c]
    g = dhl
    for c in reversed(range(n_ch)):
        g_in[c] = g
        g = decay[c] * g + w[c]
    dh0 = g
    # 3. each chunk's walk
    dxi, ddt = torch.zeros_like(xi), torch.zeros_like(xi)
    dB, dC = torch.zeros_like(bm), torch.zeros_like(cm)
    da_parts = []
    for c, (t0, n) in enumerate(spans):
        hs = []
        h = h_in[c]
        for t in range(t0, t0 + n):
            h = step(h, t)
            hs.append(h)
        for k, t in enumerate(range(t0, t0 + n)):
            dC[:, t] = (col(dy, t) * hs[k]).sum(1)
        g, da_acc = g_in[c], torch.zeros_like(h0)
        for k in reversed(range(n)):
            t = t0 + k
            hp = hs[k - 1] if k > 0 else h_in[c]
            dtv, xv, dyv = col(dt, t), col(xi, t), col(dy, t)
            bv, cv = row(bm, t), row(cm, t)
            da = torch.exp2(dtv * a2)
            g = g + dyv * cv
            dB[:, t] = (g * dtv * xv).sum(1)
            dda = g * hp
            ddt[:, t] = (dda * da * a + g * xv * bv).sum(-1)
            dxi[:, t] = (g * dtv * bv).sum(-1)
            da_acc = da_acc + dda * da * dtv
            g = g * da
        da_parts.append(da_acc)
    # 4. da over b, then the chunks, in order
    da = torch.zeros_like(a)
    for b in range(b_len):
        for part in da_parts:
            da = da + part[b]
    return dxi, ddt, dB, dC, da, dh0


def tf32_parts(x):
    """fp32 ``x`` as the fp32 routes' tf32 operands (hi, lo): hi = tf32(x),
    lo = tf32(x - hi), each rounded to nearest with ties away from zero
    through an int32 view as ``split_tf32`` rounds them (half a tf32 step
    added to the magnitude bits, the low 13 bits cleared)."""
    def rna(y):
        bits = y.contiguous().view(torch.int32)
        return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    hi = rna(x.to(torch.float32))
    return hi, rna(x.to(torch.float32) - hi)


def _tf32_products(a_parts, b_parts, single):
    """The operand pairs of one k8 step, in the kernels' order."""
    (ah, al), (bh, bl) = a_parts, b_parts
    return [(ah, bh)] if single else [(al, bh), (ah, bl), (ah, bh)]


def tf32_matmul_model(a, b, *, tiling="AF", bk=128, single=False):
    """The fp32 cim_matmul route's arithmetic: a [M, K] @ b [K, N] fp32.
    Per 32-wide K stage the hi_a hi_b steps sum into a fresh accumulator
    that is then added to the tile's sum; the small terms sum into one
    accumulator per K block (AF: all of K), added last."""
    f = torch.float32
    m, k = a.shape
    n = b.shape[1]
    ap, bp = tf32_parts(a), tf32_parts(b)
    block = bk if tiling == "PF" else max(k, 1)
    out = total = small = torch.zeros((m, n), dtype=f)
    for k0 in range(0, k, 32):
        if k0 % block == 0:
            total = small = torch.zeros((m, n), dtype=f)
        big = torch.zeros((m, n), dtype=f)
        for j in range(k0, min(k0 + 32, k), 8):
            pairs = _tf32_products([p[:, j:j + 8] for p in ap],
                                   [p[j:j + 8] for p in bp], single)
            for x, y in pairs[:-1]:
                small = small + x @ y
            big = big + pairs[-1][0] @ pairs[-1][1]
        total = total + big
        if (k0 + 32) % block == 0 or k0 + 32 >= k:
            total = total + small
            out = total if k0 < block else out + total
    return out


def _steps(parts_a, parts_b, single):
    """[steps, ...] partial products of each k8 step of an einsum over the
    last axis, in the order the kernel adds them."""
    (ah, al), (bh, bl) = parts_a, parts_b
    pairs = _tf32_products((ah, al), (bh, bl), single)
    n = ah.shape[-1] // 8
    split = lambda x: x.unflatten(-1, (n, 8))
    return [torch.einsum("bqnd,bsnd->nbqs", split(x), split(y))
            for x, y in pairs]


def _add_steps(acc, partials):
    """acc plus each step's partial products, step by step, the kernel's
    three products of a step in order."""
    for i in range(partials[0].shape[0]):
        for part in partials:
            acc = acc + part[i]
    return acc


def tf32_attention_model(q, k, v, *, causal, single=False):
    """The fp32 flash_attention route's arithmetic: q [BH, T, d], k, v
    [BH, S, d] fp32, run at the compiled width that holds d on zero-padded
    columns."""
    f = torch.float32
    d_out = q.shape[-1]
    width = next(w for w in (64, 128, 256) if d_out <= w)
    ks = 32 if width == 256 else 64
    scale = torch.tensor(1.0 / math.sqrt(d_out) * LOG2E, dtype=f)
    q, k, v = _pad_cols(width, q.to(f), k.to(f), v.to(f))
    bh, t, d = q.shape
    s_len = k.shape[1]
    steps = -(-s_len // ks)
    k, v = (torch.nn.functional.pad(x, (0, 0, 0, steps * ks - s_len))
            for x in (k, v))
    qp = tf32_parts(q)
    qpos = torch.arange(t)[:, None]
    m = torch.full((bh, t), NEG_INF, dtype=f)
    l = torch.zeros((bh, t), dtype=f)
    acc = torch.zeros((bh, t, d), dtype=f)
    for kv0 in range(0, steps * ks, ks):
        kp = tf32_parts(k[:, kv0:kv0 + ks])
        vp = tf32_parts(v[:, kv0:kv0 + ks].transpose(1, 2))   # V^T [d, keys]
        sc = _add_steps(torch.zeros((bh, t, ks), dtype=f),
                        _steps(qp, kp, single))
        kpos = torch.arange(kv0, kv0 + ks)[None, :]
        keep = kpos < s_len
        if causal:
            keep = keep & (kpos <= qpos)
        sc = torch.where(keep, sc * scale, torch.tensor(NEG_INF, dtype=f))
        m_new = torch.maximum(m, sc.max(-1).values)
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(sc - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = _add_steps(acc * alpha[..., None],
                         _steps(tf32_parts(p), vp, single))
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out[..., :d_out]
