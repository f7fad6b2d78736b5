"""Build and binding of the hand-written CUDA ``cim_matmul`` kernel.

The kernel (``csrc/cim_matmul.cu``) is the paper's AF / PF macro tiling as
a blocked ``[M, K] @ [K, N]``: AF keeps each output tile's sum in fp32
registers across K and writes it once; PF read-modify-writes the output at
its dtype once per K block (on the bf16 route keeping an A tile in shared
memory while it sweeps N tiles).  Both dtypes run on the tensor cores (``wgmma``):
bfloat16 on tiles brought by TMA, float32 in 3xTF32 (each operand split
into tf32 hi + lo parts by the kernel's producer threads, three products
summed in fp32).  It replaces the Pallas TPU kernel of the reference
(``repro/kernels/cim_matmul.py``).  Built and
loaded by ``build.py`` at first use; nothing here runs when the module is
imported.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build as _build

SOURCE = _build.CSRC / "cim_matmul.cu"
NVCC_FLAGS = _build.BASE_FLAGS

DEFAULT_BM = 128
DEFAULT_BN = 128
DEFAULT_BK = 128
#: the block sizes the kernel is compiled for (each of bm, bn, bk)
TILES = (64, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SCHEDULES = {"AF": 0, "PF": 1}


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load(SOURCE, NVCC_FLAGS)
    lib.cim_matmul.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p] * 3 + [
        ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.cim_matmul.restype = ctypes.c_int
    return lib


@functools.cache
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def check_tiling(tiling: str, bm: int, bn: int, bk: int) -> None:
    """Raise on a schedule or block size the kernel is not built for."""
    if tiling not in SCHEDULES:
        raise ValueError(f"tiling must be AF or PF, got {tiling!r}")
    for name, v in (("bm", bm), ("bn", bn), ("bk", bk)):
        if v not in TILES:
            raise ValueError(f"{name}={v} is not a supported block size "
                             f"{TILES}")


def pf_tiles_per_block(m: int, n: int, bm: int, bn: int,
                       device: torch.device) -> int:
    """N tiles each PF block sweeps: N is split so the M tiles times the
    N splits reach the card's SM count, as far as N allows."""
    gm, gn = -(-m // bm), -(-n // bn)
    sms = _sm_count(device)
    splits = min(gn, max(1, -(-sms // gm)))
    return -(-gn // splits)


def fp32_tiles(m: int, n: int, bm: int,
               device: torch.device) -> tuple[int, int]:
    """The block tile the float32 route runs a bm x bn tiling with.  For
    an fp32 output no element's arithmetic depends on the block that
    computes it, so the route runs bm x 64 blocks (the width its three
    accumulators fit), and 64 x 64 where bm x 64 would leave more than
    half of the card's SMs without a block (bk, which sets PF's K blocks,
    is kept).  bf16 runs the caller's tiles as they are."""
    if bm > 64 and -(-m // bm) * -(-n // 64) * 2 <= _sm_count(device):
        bm = 64
    return bm, 64


def tma_operands(a: torch.Tensor, b: torch.Tensor) -> tuple:
    """``a`` [M, K] and ``b`` [K, N] as TMA (bf16) and the fp32 route's
    16-byte loads of A can read them: row strides of a multiple of 16 bytes
    and 16-byte-aligned bases.  Returns the operands
    themselves where they already are, else zero-padded copies whose K and
    N are rounded up to a multiple of ``16 // itemsize``.  The added zeros
    add exact zeros to every sum and move no K block boundary (blocks start
    at multiples of bk from 0), so the product, sliced to [M, N], is
    unchanged in either schedule."""
    align = 16 // a.element_size()
    (m, k), n = a.shape, b.shape[1]
    kp, np_ = -(-k // align) * align, -(-n // align) * align
    if (kp, np_) == (k, n) and a.data_ptr() % 16 == 0 and \
            b.data_ptr() % 16 == 0:
        return a, b
    ap = a.new_zeros((m, kp))
    ap[:, :k] = a
    bp = b.new_zeros((kp, np_))
    bp[:k, :n] = b
    return ap, bp


def launch(a: torch.Tensor, b: torch.Tensor, *, tiling: str = "AF",
           bm: int = DEFAULT_BM, bn: int = DEFAULT_BN,
           bk: int = DEFAULT_BK) -> torch.Tensor:
    """One kernel launch on the current CUDA stream: ``a`` [M, K] @ ``b``
    [K, N] in a's dtype (float32 or bfloat16, both operands alike)."""
    if a.device.type != "cuda":
        raise ValueError(f"cim_matmul kernel needs CUDA tensors, got "
                         f"{a.device}")
    if a.dtype not in DTYPES:
        raise TypeError(f"cim_matmul kernel takes float32 or bfloat16, got "
                        f"{a.dtype}")
    check_tiling(tiling, bm, bn, bk)
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"need a [M, K] and b [K, N], got {tuple(a.shape)} "
                         f"and {tuple(b.shape)}")
    m, k = a.shape
    n = b.shape[1]
    _build.check_tensor("a", a, (m, k), a.dtype, a.device)
    _build.check_tensor("b", b, (k, n), a.dtype, a.device)
    if k == 0:
        return torch.zeros((m, n), dtype=a.dtype, device=a.device)
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    tpb = pf_tiles_per_block(m, n, bm, bn, a.device) if tiling == "PF" else 1
    if a.dtype == torch.float32:
        bm, bn = fp32_tiles(m, n, bm, a.device)
    a, b = tma_operands(a, b)
    k = a.shape[1]
    lib = _library()
    with torch.cuda.device(a.device):
        err = lib.cim_matmul(DTYPES[a.dtype], SCHEDULES[tiling], bm, bn, bk,
                             a.data_ptr(), b.data_ptr(), out.data_ptr(),
                             m, n, k, a.shape[1], b.shape[1], tpb,
                             _build.stream_of(a))
    _build.check_launch(lib, "cim_matmul", err)
    return out
