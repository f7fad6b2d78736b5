"""Build and binding of the hand-written CUDA ``flash_attention`` kernel.

The kernel (``csrc/flash_attention.cu``) is streaming-softmax attention,
one block per (batch-head, query tile), with the reference's masking and
guards, on the tensor cores (``wgmma``): bfloat16 on tiles brought by
TMA, float32 in 3xTF32 (each operand split into tf32 hi + lo parts by the
kernel's producer threads, three products summed in fp32).  It replaces
the Pallas TPU kernel of the reference
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
#: head widths the kernel is compiled for; a width d <= 256 with d % 8 == 0
#: runs on the smallest of them that holds it (:func:`compiled_width`)
HEAD_DIMS = (64, 128, 256)
#: the (bq, bk) tile sets that fit each compiled width's shared memory
WIDTH_TILES = {64: tuple((bq, bk) for bq in TILES for bk in TILES),
               128: tuple((bq, bk) for bq in TILES for bk in TILES),
               256: ((64, 64),)}
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def compiled_width(d: int) -> int:
    """The compiled head width that runs width ``d``: the smallest of
    ``HEAD_DIMS`` that holds it.  The kernel reads rows ``d`` wide and
    fills the rest of the compiled width with zeros, so ``d`` must be a
    multiple of 8 (TMA's rows of 2 d bytes are multiples of 16).  Raises
    on any other width."""
    if d % 8 or not 0 < d <= HEAD_DIMS[-1]:
        raise ValueError(f"head width {d} is not supported: the kernel takes "
                         f"widths up to {HEAD_DIMS[-1]} that are multiples of "
                         f"8 (compiled at {HEAD_DIMS})")
    return next(w for w in HEAD_DIMS if d <= w)


def default_tiles(d: int) -> tuple[int, int]:
    """(bq, bk) for head width ``d``: 128 x 128 where it fits, else the
    one tile set of its compiled width."""
    return max(WIDTH_TILES[compiled_width(d)])


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load(SOURCE, NVCC_FLAGS)
    lib.flash_attention.argtypes = [ctypes.c_int] * 4 + [
        ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    lib.flash_attention.restype = ctypes.c_int
    return lib


def check_tiling(bq: int | None, bk: int | None) -> None:
    """Raise on a tile size the kernel is not built for (None: the
    width's default)."""
    for name, v in (("bq", bq), ("bk", bk)):
        if v is not None and v not in TILES:
            raise ValueError(f"{name}={v} is not a supported tile size "
                             f"{TILES}")


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           causal: bool = True, bq: int | None = None, bk: int | None = None,
           return_lse: bool = False):
    """One kernel launch on the current CUDA stream: ``q`` [BH, T, d]
    against ``k``, ``v`` [BH, S, d], all float32 or all bfloat16, with
    ``bq`` x ``bk`` tiles (:func:`default_tiles` where None).  With
    ``return_lse`` it returns (out, lse), lse [BH, T] float32 the row
    log-sum-exp of the scaled, masked scores that the backward kernel
    takes (``out`` is the same either way)."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention kernel needs CUDA tensors, got "
                         f"{q.device}")
    if q.dtype not in DTYPES:
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16, "
                        f"got {q.dtype}")
    if q.dim() != 3 or k.dim() != 3:
        raise ValueError("q must be [BH, T, d] and k, v [BH, S, d]")
    bh, t, d = q.shape
    s = k.shape[1]
    width = compiled_width(d)
    if bq is None or bk is None:
        bq, bk = default_tiles(d)
    check_tiling(bq, bk)
    if (bq, bk) not in WIDTH_TILES[width]:
        raise ValueError(f"tiles bq={bq} x bk={bk} do not fit head width {d} "
                         f"(compiled at {width}: {WIDTH_TILES[width]})")
    _build.check_tensor("q", q, (bh, t, d), q.dtype, q.device)
    _build.check_tensor("k", k, (bh, s, d), q.dtype, q.device)
    _build.check_tensor("v", v, (bh, s, d), q.dtype, q.device)
    # TMA (bf16) and the fp32 route's 16-byte loads read 16-byte-aligned bases
    q, k, v = (x if x.data_ptr() % 16 == 0 else x.clone() for x in (q, k, v))
    if return_lse and s == 0:
        raise ValueError("a log-sum-exp needs S >= 1")
    out = torch.empty_like(q)
    lse = torch.empty((bh, t), dtype=torch.float32, device=q.device) \
        if return_lse else None
    lib = _library()
    with torch.cuda.device(q.device):
        err = lib.flash_attention(
            DTYPES[q.dtype], d, bq, bk, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), out.data_ptr(), bh, t, s, 1.0 / math.sqrt(d),
            int(causal), lse.data_ptr() if return_lse else None,
            _build.stream_of(q))
    _build.check_launch(lib, "flash_attention", err)
    return (out, lse) if return_lse else out
