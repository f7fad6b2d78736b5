"""Build and binding of the hand-written CUDA ``flash_attention`` kernel.

The kernel (``csrc/flash_attention.cu``) is streaming-softmax attention,
one block per (batch-head, query tile), with the reference's masking and
guards.  It replaces the Pallas TPU kernel of the reference
(``repro/kernels/flash_attention.py``).  Built and loaded by ``build.py``
at first use; nothing here runs when the module is imported.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build as _build

SOURCE = _build.CSRC / "flash_attention.cu"
NVCC_FLAGS = _build.BASE_FLAGS

#: query and key tile sizes the kernel is compiled for (each of bq, bk)
TILES = (64, 128)
#: head widths the kernel is compiled for
HEAD_DIMS = (64, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load(SOURCE, NVCC_FLAGS)
    lib.flash_attention.argtypes = [ctypes.c_int] * 4 + [
        ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    lib.flash_attention.restype = ctypes.c_int
    return lib


def check_tiling(bq: int, bk: int) -> None:
    """Raise on a tile size the kernel is not built for."""
    for name, v in (("bq", bq), ("bk", bk)):
        if v not in TILES:
            raise ValueError(f"{name}={v} is not a supported tile size "
                             f"{TILES}")


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           causal: bool = True, bq: int = 128,
           bk: int = 128) -> torch.Tensor:
    """One kernel launch on the current CUDA stream: ``q`` [BH, T, d]
    against ``k``, ``v`` [BH, S, d], all float32 or all bfloat16."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention kernel needs CUDA tensors, got "
                         f"{q.device}")
    if q.dtype not in DTYPES:
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16, "
                        f"got {q.dtype}")
    check_tiling(bq, bk)
    if q.dim() != 3 or k.dim() != 3:
        raise ValueError("q must be [BH, T, d] and k, v [BH, S, d]")
    bh, t, d = q.shape
    s = k.shape[1]
    if d not in HEAD_DIMS:
        raise ValueError(f"head width {d} is not supported {HEAD_DIMS}")
    _build.check_tensor("q", q, (bh, t, d), q.dtype, q.device)
    _build.check_tensor("k", k, (bh, s, d), q.dtype, q.device)
    _build.check_tensor("v", v, (bh, s, d), q.dtype, q.device)
    out = torch.empty_like(q)
    lib = _library()
    with torch.cuda.device(q.device):
        err = lib.flash_attention(
            DTYPES[q.dtype], d, bq, bk, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), out.data_ptr(), bh, t, s, 1.0 / math.sqrt(d),
            int(causal), _build.stream_of(q))
    _build.check_launch(lib, "flash_attention", err)
    return out
