"""The bf16 tensor-core matmul's TMA padding (``cim_matmul.tma_operands``)
changes no result: TMA reads rows whose strides are multiples of 16
bytes, so where K or N is not a multiple of 16 / itemsize (or a base is
misaligned) the wrapper pads with zeros.  On the shapes of
tests/test_kernels.py, for both bk values, in fp32 and bf16, AF and PF,
the plain version on the padded operands, sliced to [M, N], equals the
plain version on the operands themselves bit for bit; an aligned shape is
not copied."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import cim_matmul as cm
from repro_torch.kernels import ref

SHAPES = [(64, 64, 64), (200, 300, 250), (128, 128, 128), (1, 700, 130),
          (257, 129, 255)]
DTYPES = [torch.float32, torch.bfloat16]


def _operands(shape, dtype, seed=0):
    m, k, n = shape
    rng = np.random.default_rng(seed)
    a = torch.as_tensor(rng.standard_normal((m, k)), dtype=torch.float32)
    b = torch.as_tensor(rng.standard_normal((k, n)), dtype=torch.float32)
    return a.to(dtype), b.to(dtype)


@pytest.mark.parametrize("tiling", ["AF", "PF"])
@pytest.mark.parametrize("bk", cm.TILES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_padded_product_equals_unpadded(shape, dtype, bk, tiling):
    a, b = _operands(shape, dtype)
    ap, bp = cm.tma_operands(a, b)
    n = shape[2]
    want = ref.matmul_ref(a, b, tiling=tiling, bk=bk)
    got = ref.matmul_ref(ap, bp, tiling=tiling, bk=bk)[:, :n]
    assert got.dtype == want.dtype
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_padding_is_aligned_zeros(shape, dtype):
    m, k, n = shape
    a, b = _operands(shape, dtype)
    ap, bp = cm.tma_operands(a, b)
    align = 16 // a.element_size()
    assert ap.shape[1] % align == 0 and bp.shape[1] % align == 0
    assert ap.shape[1] == bp.shape[0] and ap.shape[0] == m
    assert ap.shape[1] - k < align and bp.shape[1] - n < align
    assert torch.equal(ap[:, :k], a) and torch.equal(bp[:k, :n], b)
    assert not ap[:, k:].any() and not bp[k:].any() and not bp[:, n:].any()
    assert ap.is_contiguous() and bp.is_contiguous()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(64, 64, 64), (128, 128, 128),
                                   (1, 64, 8), (512, 1024, 4096)])
def test_aligned_shape_is_not_copied(shape, dtype):
    a, b = _operands(shape, dtype)
    ap, bp = cm.tma_operands(a, b)
    assert ap is a and bp is b


def test_misaligned_base_is_copied():
    buf = torch.zeros(1 + 64 * 64, dtype=torch.bfloat16)
    a = buf[1:].view(64, 64)             # contiguous, base 2 bytes off
    b = torch.ones((64, 64), dtype=torch.bfloat16)
    ap, bp = cm.tma_operands(a, b)
    assert ap is not a and ap.data_ptr() % 16 == 0
    assert torch.equal(ap, a) and bp is not b and torch.equal(bp, b)
