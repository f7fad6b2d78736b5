"""A CPU rehearsal of the fp32 routes' 3xTF32 arithmetic.

``tf32_matmul_model`` and ``tf32_attention_model`` (tests/torch_kernel_models.py)
repeat the fp32 routes of ``csrc/cim_matmul.cu`` and
``csrc/flash_attention.cu`` in plain PyTorch: every operand split into tf32
hi + lo parts (``tf32_parts``: hi = tf32(x), lo = tf32(x - hi), rounded
through an int32 view as the kernels round them), each
k8 step adding lo_a hi_b, hi_a lo_b and hi_a hi_b in the kernels' order,
the matmul's stage sums added on the side, the attention's softmax in the
kernel's key steps.  They are held at the fp32 shapes of
tests/test_torch_kernels_cuda.py against ``ref.matmul_ref`` /
``ref.attention_ref`` at the card's tolerances (matmul atol = rtol = 1e-4,
attention atol 2e-3), and against the JAX reference's Pallas kernels in
interpret mode at tests/test_kernels.py's tolerances.  The same matmul
with one tf32 product (hi_a hi_b alone) breaks the 1e-4 tolerance at
(200, 300, 250): that is why the routes run three."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ref

from torch_kernel_models import (tf32_attention_model, tf32_matmul_model,
                                 tf32_parts)

#: the card's fp32 tolerances (tests/test_torch_kernels_cuda.py)
MM_TOL, ATTN_ATOL = 1e-4, 2e-3
#: the fp32 matmul shapes of tests/test_torch_kernels_cuda.py, with the
#: (bm, bn, bk) each runs at there
MM_CASES = ([(s, t) for s in ((64, 64, 64), (200, 300, 250), (128, 128, 128),
                              (1, 700, 130), (257, 129, 255))
             for t in ((128, 128, 128), (64, 128, 64))]
            + [((257, 300, 250), (bm, bn, bk)) for bm in (64, 128)
               for bn in (64, 128) for bk in (64, 128)]
            + [((512, 4096, 1024), (128, 128, 128)),
               ((128, 192, 136), (128, 128, 128))])
#: the fp32 attention shapes there: (BH, T, S, d)
ATTN_SHAPES = [(2, 128, 128, 64), (1, 200, 300, 64), (3, 129, 257, 128),
               *((2, 129, 257, d) for d in (16, 120, 200, 256)),
               (2, 1000, 1533, 128), (2, 1533, 1000, 128), (1, 128, 96, 64)]


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [np.asarray(rng.standard_normal(s), np.float32) for s in shapes]


def _t(x):
    return torch.as_tensor(x)


def test_tf32_parts_split_exactly():
    """hi and lo have at most 11 significant bits (the low 13 are zero),
    |x - hi| <= 2^-11 |x|, and hi + lo is within 2^-22 of x relative."""
    x = _t((_arrays(0, (4096,))[0] * 10.0 ** np.arange(-8, 8).repeat(256))
           .astype(np.float32))
    hi, lo = tf32_parts(x)
    assert not bool((hi.view(torch.int32) & 0x1FFF).any())
    assert not bool((lo.view(torch.int32) & 0x1FFF).any())
    assert bool(((x - hi).abs() <= x.abs() * 2.0 ** -11).all())
    err = ((hi.double() + lo.double()) - x.double()).abs()
    assert bool((err <= x.double().abs() * 2.0 ** -22).all())


@pytest.mark.parametrize("tiling", ["AF", "PF"])
@pytest.mark.parametrize("shape,tiles", MM_CASES,
                         ids=lambda x: "x".join(map(str, x)))
def test_matmul_model_within_card_tolerance(shape, tiles, tiling):
    m, k, n = shape
    a, b = (_t(x) for x in _arrays(11, (m, k), (k, n)))
    bk = tiles[2]
    got = tf32_matmul_model(a, b, tiling=tiling, bk=bk)
    torch.testing.assert_close(got, ref.matmul_ref(a, b, tiling=tiling,
                                                   bk=bk),
                               atol=MM_TOL, rtol=MM_TOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", ATTN_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_attention_model_within_card_tolerance(shape, causal):
    bh, t, s, d = shape
    q, k, v = (_t(x) for x in _arrays(14, (bh, t, d), (bh, s, d), (bh, s, d)))
    got = tf32_attention_model(q, k, v, causal=causal)
    want = ref.attention_ref(q, k, v, causal=causal)
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, atol=ATTN_ATOL, rtol=0)


@pytest.mark.parametrize("tiling", ["AF", "PF"])
@pytest.mark.parametrize("shape", [(64, 64, 64), (200, 300, 250),
                                   (128, 128, 128), (1, 700, 130),
                                   (257, 129, 255)],
                         ids=lambda s: "x".join(map(str, s)))
def test_matmul_model_within_tolerance_of_jax_reference(shape, tiling):
    import jax.numpy as jnp

    from repro.kernels import ops as ref_ops
    m, k, n = shape
    an, bn = _arrays(17, (m, k), (k, n))
    pallas = ref_ops.cim_matmul(jnp.asarray(an), jnp.asarray(bn),
                                tiling=tiling, interpret=True)
    got = tf32_matmul_model(_t(an), _t(bn), tiling=tiling)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas, np.float32),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [(2, 128, 128, 64), (1, 200, 300, 64),
                                   (3, 129, 257, 128)],
                         ids=lambda s: "x".join(map(str, s)))
def test_attention_model_within_tolerance_of_jax_reference(shape, causal):
    import jax.numpy as jnp

    from repro.kernels import ops as ref_ops
    bh, t, s, d = shape
    qn, kn, vn = _arrays(19, (bh, t, d), (bh, s, d), (bh, s, d))
    pallas = ref_ops.flash_attention(
        *(jnp.asarray(x) for x in (qn, kn, vn)), causal=causal,
        interpret=True)
    got = tf32_attention_model(_t(qn), _t(kn), _t(vn), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas, np.float32),
                               atol=2e-3)


def test_single_tf32_product_breaks_the_card_tolerance():
    """hi_a hi_b alone (one tf32 product, about 2^-11 relative) leaves the
    1e-4 tolerance at (200, 300, 250); the three products stay inside."""
    a, b = (_t(x) for x in _arrays(11, (200, 300), (300, 250)))
    want = ref.matmul_ref(a, b)

    def excess(got):
        return float(((got - want).abs() - (MM_TOL + MM_TOL * want.abs()))
                     .max())

    assert excess(tf32_matmul_model(a, b)) <= 0
    assert excess(tf32_matmul_model(a, b, single=True)) > 0
