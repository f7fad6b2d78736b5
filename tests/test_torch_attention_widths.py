"""The attention kernels' arithmetic at the head widths the kernels run
on a wider compiled width: h2o-danube-3-4b's 120 (on 128), 200 (on 256)
and the reduced configs' 16 (on 64), and gemma-7b's and
recurrentgemma-9b's 256 (its own width).

``kernel_model`` and ``bwd_kernel_model`` (``tests/torch_kernel_models.py``)
take ``width``: the inputs padded with zero columns to the compiled width,
as TMA's out-of-range fill pads the kernels' tiles, the scale of the true
width, the outputs cut to it.  Held two ways:

* the padded instantiation equals the unpadded arithmetic bit for bit
  (zero columns add exact zeros to Q K^T and dO V^T and give output
  columns that are dropped);
* against the reference: the forward against its Pallas kernel in
  interpret mode (tests/test_kernels.py's bf16 3e-2) and against the plain
  version at chip_smoke.py's bf16 tolerance (atol 1e-3, rtol 2^-7); the
  backward against autograd of the plain version at chip_smoke.py's row
  bar (``BWD_TOL``) on random, peaked and shared-component rows, and
  against ``jax.vjp`` of the reference's jnp attention in fp32.

The widths' tile sets (64 x 64 only at 256) are the kernels'
(``flash_attention.WIDTH_TILES``); widths above 256 or not multiples of 8
raise.
"""
import pathlib
import sys

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref

from torch_kernel_models import bwd_kernel_model, kernel_model, peaked

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

#: chip_smoke.py's bf16 attention tolerance, kernel against plain
ATOL, RTOL = 1e-3, 2 ** -7
WIDTHS = (16, 120, 200, 256)


def _bf16(rng, *shape):
    return torch.as_tensor(rng.standard_normal(shape),
                           dtype=torch.float32).to(torch.bfloat16)


def _inputs(bh, t, s, d, seed):
    rng = np.random.default_rng(seed)
    return _bf16(rng, bh, t, d), _bf16(rng, bh, s, d), _bf16(rng, bh, s, d), \
        _bf16(rng, bh, t, d)


def _excess(got, want) -> float:
    g, w = got.float(), want.float()
    return float(((g - w).abs() - (ATOL + RTOL * w.abs())).max())


def test_compiled_widths_and_tiles():
    assert fa.HEAD_DIMS == (64, 128, 256)
    assert [fa.compiled_width(d) for d in (8, 16, 64, 72, 120, 128, 136,
                                           200, 256)] == \
        [64, 64, 64, 128, 128, 128, 256, 256, 256]
    assert fa.default_tiles(120) == (128, 128)
    assert fa.default_tiles(256) == (64, 64)
    for d in (12, 320, 0, 264):
        with pytest.raises(ValueError, match=f"head width {d} is not"):
            fa.compiled_width(d)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", WIDTHS)
def test_forward_padded_equals_unpadded(d, causal):
    q, k, v, _ = _inputs(2, 130, 97, d, d)
    width = fa.compiled_width(d)
    for bq, bk in fa.WIDTH_TILES[width]:
        kw = dict(causal=causal, bq=bq, bk=bk)
        padded = kernel_model(q, k, v, width=width, **kw)
        assert padded.shape == q.shape
        assert torch.equal(padded, kernel_model(q, k, v, **kw)), (bq, bk)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", WIDTHS)
def test_backward_padded_equals_unpadded(d, causal):
    q, k, v, do = _inputs(2, 130, 97, d, d + 1)
    width = fa.compiled_width(d)
    padded = bwd_kernel_model(q, k, v, do, causal=causal, width=width)
    plain = bwd_kernel_model(q, k, v, do, causal=causal)
    for name, p, u in zip(("dq", "dk", "dv"), padded, plain):
        assert p.shape == u.shape
        assert torch.equal(p, u), name


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [120, 256])
def test_forward_against_plain_and_pallas(d, causal):
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.kernels import ops as ref_ops
    q, k, v, _ = _inputs(2, 128, 128, d, 3 * d)
    width = fa.compiled_width(d)
    bq, bk = fa.default_tiles(d)
    got = kernel_model(q, k, v, causal=causal, bq=bq, bk=bk, width=width)
    assert _excess(got, ref.attention_ref(q, k, v, causal=causal)) <= 0
    pallas = ref_ops.flash_attention(
        *(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
          for x in (q, k, v)), causal=causal, interpret=True)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(pallas, np.float32), atol=3e-2)


@pytest.mark.parametrize("kind", ["random", "peaked", "shared"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [120, 256])
@pytest.mark.parametrize("bh,t,s", [(2, 200, 133), (2, 65, 130)])
def test_backward_within_the_card_bar(bh, t, s, d, causal, kind):
    q, k, v, do = _inputs(bh, t, s, d, t + s + d)
    if kind == "peaked":
        q = peaked(q, k, causal=causal)
    elif kind == "shared":
        common = torch.as_tensor(np.random.default_rng(d).standard_normal(
            (2, d)), dtype=torch.float32)
        q = (q.float() + 4 * common[0]).bfloat16()
        k = (k.float() + 4 * common[1]).bfloat16()
    got = bwd_kernel_model(q, k, v, do, causal=causal,
                           width=fa.compiled_width(d))
    want = ref.attention_bwd_ref(q, k, v, do, causal=causal)
    chip_smoke.check_bwd(f"model d={d} {kind}", "flash_attention_bwd", got,
                         want)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [120, 256])
def test_backward_against_the_jax_reference(d, causal):
    """The model against ``jax.vjp`` of the reference's jnp attention in
    fp32 on the same bf16-valued inputs, under the card's row bar."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.kernels import ref as jref
    q, k, v, do = _inputs(2, 96, 96, d, 5 * d)
    to_jax = lambda x: jnp.asarray(x.float().numpy())
    _, vjp = jax.vjp(lambda q_, k_, v_: jref.attention_ref(
        q_, k_, v_, causal=causal), to_jax(q), to_jax(k), to_jax(v))
    want = [torch.as_tensor(np.array(g, np.float32)).to(torch.bfloat16)
            for g in vjp(to_jax(do))]
    got = bwd_kernel_model(q, k, v, do, causal=causal,
                           width=fa.compiled_width(d))
    chip_smoke.check_bwd(f"model d={d} against jax.vjp",
                         "flash_attention_bwd", got, tuple(want))
