"""The port's kernel wrappers on CPU tensors (their plain versions) held
against the reference: its Pallas kernels run in interpret mode
(``repro.kernels.ops``, ``interpret=True``) and its jnp oracles
(``repro.kernels.ref``), on the shapes and dtypes of tests/test_kernels.py
and at its tolerances: matmul 1e-4 (fp32) / 0.2 (bf16), attention 2e-3 /
3e-2, selective scan 1e-3 / 0.15.  The same numpy draws feed both
packages; bf16 inputs are rounded from float32 in each."""
import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels import ops as ref_ops  # noqa: E402
from repro.kernels import ref as ref_ref  # noqa: E402

from repro_torch.kernels import ops, ref  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(x: np.ndarray, dtype: str):
    """One float32 numpy array as a jnp array and a CPU tensor of ``dtype``."""
    x = np.asarray(x, np.float32)
    jd, td = DTYPES[dtype]
    return jnp.asarray(x).astype(jd), torch.as_tensor(x).to(td)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("tiling", ["AF", "PF"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(64, 64, 64), (200, 300, 250),
                                   (128, 128, 128), (1, 700, 130),
                                   (257, 129, 255)])
def test_cim_matmul_matches_reference(tiling, dtype, shape):
    m, k, n = shape
    rng = np.random.default_rng(hash(shape) % 2**32)
    ja, ta = _pair(rng.standard_normal((m, k)), dtype)
    jb, tb = _pair(rng.standard_normal((k, n)), dtype)
    got = ops.cim_matmul(ta, tb, tiling=tiling)
    assert got.dtype == ta.dtype and got.shape == (m, n)
    tol = 1e-4 if dtype == "float32" else 0.2
    pallas = ref_ops.cim_matmul(ja, jb, tiling=tiling, interpret=True)
    np.testing.assert_allclose(_np(got), _np(pallas), atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(got), _np(ref_ref.matmul_ref(ja, jb)),
                               atol=tol, rtol=tol)


def test_cim_matmul_af_pf_psum_width():
    """The port's plain PF accumulates at output width: in bf16 AF is at
    least as accurate as PF (tests/test_kernels.py:29-43), and PF is not
    AF (the psum rounding really happens)."""
    rng = np.random.default_rng(7)
    a = torch.as_tensor(rng.standard_normal((128, 2048)),
                        dtype=torch.float32).to(torch.bfloat16)
    b = torch.as_tensor(rng.standard_normal((2048, 128)),
                        dtype=torch.float32).to(torch.bfloat16)
    exact = ref.matmul_ref(a, b, out_dtype=torch.float32).numpy()
    af = _np(ops.cim_matmul(a, b, tiling="AF"))
    pf = _np(ops.cim_matmul(a, b, tiling="PF"))
    err_af = np.abs(af - exact).mean()
    err_pf = np.abs(pf - exact).mean()
    assert err_af <= err_pf + 1e-6
    assert not np.array_equal(af, pf)


def test_cim_matmul_pf_rounds_like_pallas_pf():
    """PF's per-block bf16 rounding follows _kernel_pf: the port's plain
    PF is closer to the Pallas PF than to the Pallas AF."""
    rng = np.random.default_rng(11)
    ja, ta = _pair(rng.standard_normal((128, 1024)), "bfloat16")
    jb, tb = _pair(rng.standard_normal((1024, 128)), "bfloat16")
    pf = _np(ops.cim_matmul(ta, tb, tiling="PF"))
    want_pf = _np(ref_ops.cim_matmul(ja, jb, tiling="PF", interpret=True))
    want_af = _np(ref_ops.cim_matmul(ja, jb, tiling="AF", interpret=True))
    assert np.abs(pf - want_pf).mean() < np.abs(pf - want_af).mean()


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [(2, 128, 128, 64), (1, 200, 300, 64),
                                   (3, 129, 257, 128)])
def test_flash_attention_matches_reference(causal, shape):
    bh, t, s, d = shape
    rng = np.random.default_rng(hash(shape) % 2**32)
    jq, tq = _pair(rng.standard_normal((bh, t, d)), "float32")
    jk, tk = _pair(rng.standard_normal((bh, s, d)), "float32")
    jv, tv = _pair(rng.standard_normal((bh, s, d)), "float32")
    got = ops.flash_attention(tq, tk, tv, causal=causal)
    assert got.shape == (bh, t, d)
    pallas = ref_ops.flash_attention(jq, jk, jv, causal=causal,
                                     interpret=True)
    np.testing.assert_allclose(_np(got), _np(pallas), atol=2e-3)
    np.testing.assert_allclose(
        _np(got), _np(ref_ref.attention_ref(jq, jk, jv, causal=causal)),
        atol=2e-3)


def test_flash_attention_bf16():
    rng = np.random.default_rng(3)
    jq, tq = _pair(rng.standard_normal((2, 256, 64)), "bfloat16")
    jk, tk = _pair(rng.standard_normal((2, 256, 64)), "bfloat16")
    jv, tv = _pair(rng.standard_normal((2, 256, 64)), "bfloat16")
    got = ops.flash_attention(tq, tk, tv, causal=True)
    assert got.dtype == torch.bfloat16
    pallas = ref_ops.flash_attention(jq, jk, jv, causal=True, interpret=True)
    np.testing.assert_allclose(_np(got), _np(pallas), atol=3e-2)
    np.testing.assert_allclose(
        _np(got), _np(ref_ref.attention_ref(jq, jk, jv, causal=True)),
        atol=3e-2)


def _scan_inputs(rng, shape, dtype="float32", h0_zero=False):
    b, t, i, s = shape
    xs = [rng.standard_normal((b, t, i)),
          np.abs(rng.standard_normal((b, t, i))) * 0.1,
          rng.standard_normal((b, t, s)), rng.standard_normal((b, t, s))]
    a = -np.abs(rng.standard_normal((i, s)))
    h0 = np.zeros((b, i, s)) if h0_zero else rng.standard_normal((b, i, s))
    pairs = [_pair(x, dtype) for x in xs] + [_pair(a, "float32"),
                                             _pair(h0, "float32")]
    return [p[0] for p in pairs], [p[1] for p in pairs]


@pytest.mark.parametrize("shape", [(1, 64, 32, 8), (2, 100, 48, 16),
                                   (1, 33, 17, 4)])
def test_selective_scan_matches_reference(shape):
    jargs, targs = _scan_inputs(np.random.default_rng(hash(shape) % 2**32),
                                shape)
    y, hl = ops.selective_scan(*targs, ct=16, ci=16)
    b, t, i, s = shape
    assert y.shape == (b, t, i) and hl.shape == (b, i, s)
    py, ph = ref_ops.selective_scan(*jargs, ct=16, ci=16, interpret=True)
    ry, rh = ref_ref.selective_scan_ref(*jargs)
    for want_y, want_h in ((py, ph), (ry, rh)):
        np.testing.assert_allclose(_np(y), _np(want_y), atol=1e-3)
        np.testing.assert_allclose(_np(hl), _np(want_h), atol=1e-3)


def test_selective_scan_bf16():
    jargs, targs = _scan_inputs(np.random.default_rng(5), (1, 64, 32, 8),
                                "bfloat16", h0_zero=True)
    y, hl = ops.selective_scan(*targs, ct=16, ci=16)
    assert y.dtype == torch.bfloat16 and hl.dtype == torch.float32
    py, _ = ref_ops.selective_scan(*jargs, ct=16, ci=16, interpret=True)
    ry, _ = ref_ref.selective_scan_ref(
        *[x.astype(jnp.float32) for x in jargs])
    np.testing.assert_allclose(_np(y), _np(py), atol=0.15)
    np.testing.assert_allclose(_np(y), _np(ry), atol=0.15)


@pytest.mark.parametrize("call", [
    lambda t: ops.cim_matmul(t, t, bm=96),
    lambda t: ops.cim_matmul(t, t, tiling="XF"),
    lambda t: ops.flash_attention(t[None], t[None], t[None], bq=32),
    lambda t: ops.selective_scan(t[None], t[None], t[None], t[None], t,
                                 t[None], ct=8),
], ids=["matmul-bm", "matmul-schedule", "attention-bq", "scan-ct"])
def test_unsupported_tiling_raises(call):
    """Tiling keywords select the kernel's tiles, so a value it is not
    built for raises, on the CPU route as on the card's."""
    with pytest.raises(ValueError):
        call(torch.zeros((64, 64)))


def test_cpu_route_counts_no_launch():
    before = (ops.cim_matmul.launches, ops.flash_attention.launches,
              ops.selective_scan.launches)
    x = torch.ones((64, 64))
    ops.cim_matmul(x, x)
    ops.flash_attention(x[None], x[None], x[None])
    assert (ops.cim_matmul.launches, ops.flash_attention.launches,
            ops.selective_scan.launches) == before
