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

from torch_kernel_models import kernel_model

#: chip_smoke.py's bf16 attention tolerance, kernel against plain
ATOL, RTOL = 1e-3, 2 ** -7
#: the bf16 shapes of the tests: tests/test_kernels.py's and chip_smoke's
#: tile sweep with T != S, both ragged
SHAPES = [(2, 256, 256, 64, True)] + [
    (2, t, s, d, causal) for d in (64, 128) for t, s in ((200, 333),
                                                         (333, 200))
    for causal in (False, True)]
TILES = [(64, 64), (64, 128), (128, 64), (128, 128)]


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
