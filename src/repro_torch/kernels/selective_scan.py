"""Build and binding of the hand-written CUDA ``selective_scan`` kernel.

The kernel (``csrc/selective_scan.cu``) is the Mamba-1 recurrence,
sequential over time, one thread per (batch row, channel) with its states
in registers.  It replaces the Pallas TPU kernel of the reference
(``repro/kernels/selective_scan.py``).  Built and loaded by ``build.py``
at first use; nothing here runs when the module is imported.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build as _build

SOURCE = _build.CSRC / "selective_scan.cu"
NVCC_FLAGS = _build.BASE_FLAGS

DEFAULT_CT = 128       # time steps of B and C staged per chunk
DEFAULT_CI = 256       # channels (threads) per block
#: the chunk lengths and channel tiles the kernel takes
CT_TILES = (16, 32, 64, 128)
CI_TILES = (16, 32, 64, 128, 256)
MAX_STATE = 16
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load(SOURCE, NVCC_FLAGS)
    lib.selective_scan.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 8 + [
        ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.selective_scan.restype = ctypes.c_int
    return lib


def check_tiling(ct: int, ci: int) -> None:
    """Raise on a chunk length or channel tile the kernel does not take."""
    if ct not in CT_TILES:
        raise ValueError(f"ct={ct} is not a supported chunk length {CT_TILES}")
    if ci not in CI_TILES:
        raise ValueError(f"ci={ci} is not a supported channel tile {CI_TILES}")


def launch(xi, dt, bmat, cmat, a, h0, *, ct: int = DEFAULT_CT,
           ci: int = DEFAULT_CI) -> tuple[torch.Tensor, torch.Tensor]:
    """One kernel launch on the current CUDA stream.  ``xi``, ``dt``
    [B, T, I] and ``bmat``, ``cmat`` [B, T, S] of one dtype (float32 or
    bfloat16); ``a`` [I, S] and ``h0`` [B, I, S] float32.  Returns
    (y [B, T, I] in the inputs' dtype, h_last [B, I, S] float32).  As in
    the reference, the channel tile is ``min(ci, I)``."""
    if xi.device.type != "cuda":
        raise ValueError(f"selective_scan kernel needs CUDA tensors, got "
                         f"{xi.device}")
    if xi.dtype not in DTYPES:
        raise TypeError(f"selective_scan kernel takes float32 or bfloat16 "
                        f"inputs, got {xi.dtype}")
    check_tiling(ct, ci)
    if xi.dim() != 3 or a.dim() != 2:
        raise ValueError("xi must be [B, T, I] and a [I, S]")
    b, t, i = xi.shape
    s = a.shape[1]
    if not 1 <= s <= MAX_STATE:
        raise ValueError(f"state width {s} is outside 1..{MAX_STATE}")
    dev = xi.device
    for name, x, shape, dtype in (
            ("xi", xi, (b, t, i), xi.dtype), ("dt", dt, (b, t, i), xi.dtype),
            ("bmat", bmat, (b, t, s), xi.dtype),
            ("cmat", cmat, (b, t, s), xi.dtype),
            ("a", a, (i, s), torch.float32),
            ("h0", h0, (b, i, s), torch.float32)):
        _build.check_tensor(name, x, shape, dtype, dev)
    y = torch.empty_like(xi)
    hlast = torch.empty_like(h0)
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.selective_scan(
            DTYPES[xi.dtype], xi.data_ptr(), dt.data_ptr(), bmat.data_ptr(),
            cmat.data_ptr(), a.data_ptr(), h0.data_ptr(), y.data_ptr(),
            hlast.data_ptr(), b, t, i, s, ct, min(ci, i), _build.stream_of(xi))
    _build.check_launch(lib, "selective_scan", err)
    return y, hlast
