"""A CPU rehearsal of the bf16 tensor-core attention's rounding points.

``kernel_model`` repeats the arithmetic of the bf16 route of
``csrc/flash_attention.cu`` in plain PyTorch: q tiles of bq rows, the
softmax in steps of bk keys (64 with bq = 128, where the kernel's two
consumer warpgroups split a kv tile into 64-key steps; steps past S or
wholly above the causal diagonal skipped), scores from bf16 inputs summed
in fp32, scale and masks in log2 units, a running max and an fp32
denominator per row, P split into bf16 hi + lo parts for P V with an fp32
accumulator, out = acc / max(l, 1e-30) rounded to bf16.  It is held
at the bf16 shapes of the tests against ``ref.attention_ref`` with
chip_smoke.py's bf16 tolerance (atol 1e-3, rtol 2^-7) and against the JAX
reference's Pallas kernel in interpret mode at tests/test_kernels.py's
3e-2.  The same model with one bf16 rounding of P (``split=False``)
breaks the first tolerance: that is why the kernel runs P V twice."""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref

NEG_INF = -1e30
LOG2E = 1.4426950408889634
#: chip_smoke.py's bf16 attention tolerance, kernel against plain
ATOL, RTOL = 1e-3, 2 ** -7
#: the bf16 shapes of the tests: tests/test_kernels.py's and chip_smoke's
#: tile sweep with T != S, both ragged
SHAPES = [(2, 256, 256, 64, True)] + [
    (2, t, s, d, causal) for d in (64, 128) for t, s in ((200, 333),
                                                         (333, 200))
    for causal in (False, True)]
TILES = [(64, 64), (64, 128), (128, 64), (128, 128)]


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


def _inputs(shape, seed):
    bh, t, s, d, _ = shape
    rng = np.random.default_rng(seed)
    return [np.asarray(rng.standard_normal((bh, n, d)), np.float32)
            for n in (t, s, s)]


def _bf16(x):
    return torch.as_tensor(x).to(torch.bfloat16)


def _excess(got, want) -> float:
    """Largest |got - want| beyond atol + rtol |want| (<= 0: within)."""
    g, w = got.float(), want.float()
    return float(((g - w).abs() - (ATOL + RTOL * w.abs())).max())


@pytest.mark.parametrize("tiles", TILES, ids=lambda t: f"bq{t[0]}xbk{t[1]}")
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_model_within_card_tolerance_of_plain(shape, tiles):
    q, k, v = (_bf16(x) for x in _inputs(shape, 13))
    causal = shape[4]
    got = kernel_model(q, k, v, causal=causal, bq=tiles[0], bk=tiles[1])
    want = ref.attention_ref(q, k, v, causal=causal)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert bool(torch.isfinite(got.float()).all())
    assert _excess(got, want) <= 0


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_model_within_tolerance_of_jax_reference(shape):
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.kernels import ops as ref_ops
    qn, kn, vn = _inputs(shape, 17)
    causal = shape[4]
    pallas = ref_ops.flash_attention(
        *(jnp.asarray(x).astype(jnp.bfloat16) for x in (qn, kn, vn)),
        causal=causal, interpret=True)
    got = kernel_model(*(_bf16(x) for x in (qn, kn, vn)), causal=causal,
                       bq=128, bk=128)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(pallas, np.float32), atol=3e-2)


def test_single_rounding_of_p_breaks_the_card_tolerance():
    """One bf16 rounding of P (what a plain bf16 P V would do) leaves the
    card's tolerance on these shapes; the hi + lo split stays inside."""
    worst_single = worst_split = -math.inf
    for shape in SHAPES:
        q, k, v = (_bf16(x) for x in _inputs(shape, 13))
        want = ref.attention_ref(q, k, v, causal=shape[4])
        for bq, bk in TILES:
            kw = dict(causal=shape[4], bq=bq, bk=bk)
            worst_single = max(worst_single, _excess(
                kernel_model(q, k, v, split=False, **kw), want))
            worst_split = max(worst_split,
                              _excess(kernel_model(q, k, v, **kw), want))
    assert worst_split <= 0 < worst_single
