"""Build and binding of the hand-written CUDA ``flash_attention_bwd``
kernel.

The kernel (``csrc/flash_attention_bwd.cu``) is the gradient of the
``flash_attention`` kernel's bf16 route: ``dq``, ``dk``, ``dv`` from
``q``, ``k``, ``v``, the output's gradient ``do`` and the forward's row
log-sum-exp.  Every product is a bf16 ``wgmma`` on the tensor cores with
fp32 sums, its tiles brought by TMA, in two launches that recompute the
softmax from the log-sum-exp: a dq pass over q tiles that first sums
``D = rowsum(P * dP)`` per query in fp32 (written to a scratch row for
the next launch) and then adds ``dS K``, and a dk/dv pass over kv tiles
that adds ``P^T dO`` and ``dS^T Q``.  P is rounded to bf16 once and dS
split into bf16 hi + lo parts (dS sums to 0 over a row's keys, and dq
must keep that cancellation): 11 products a (query, key) pair, and no
float atomics, so every run gives the same bits.  The reference has
no backward kernel (it differentiates jnp attention).  Built and loaded
by ``build.py`` at first use; nothing here runs when the module is
imported.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build as _build

SOURCE = _build.CSRC / "flash_attention_bwd.cu"
NVCC_FLAGS = _build.BASE_FLAGS

#: head widths the kernel is compiled for (the forward's)
HEAD_DIMS = (64, 128)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load(SOURCE, NVCC_FLAGS)
    lib.flash_attention_bwd.argtypes = [ctypes.c_int] + [
        ctypes.c_void_p] * 9 + [ctypes.c_int] * 3 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    lib.flash_attention_bwd.restype = ctypes.c_int
    return lib


def launch(q, k, v, do, lse, *, causal: bool = True):
    """One backward call (two kernel launches) on the current CUDA
    stream: ``q``, ``do`` [BH, T, d] and ``k``, ``v`` [BH, S, d] bfloat16,
    ``lse`` [BH, T] float32 from the forward.  Returns (dq, dk, dv)
    bfloat16."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd kernel needs CUDA tensors, got "
                         f"{q.device}")
    if q.dim() != 3 or k.dim() != 3:
        raise ValueError("q must be [BH, T, d] and k, v [BH, S, d]")
    bh, t, d = q.shape
    s = k.shape[1]
    if d not in HEAD_DIMS:
        raise ValueError(f"head width {d} is not supported {HEAD_DIMS}")
    if t == 0 or s == 0:
        raise ValueError("flash_attention_bwd needs T >= 1 and S >= 1")
    bf = torch.bfloat16
    for name, x, shape in (("q", q, (bh, t, d)), ("k", k, (bh, s, d)),
                           ("v", v, (bh, s, d)), ("do", do, (bh, t, d))):
        _build.check_tensor(name, x, shape, bf, q.device)
    _build.check_tensor("lse", lse, (bh, t), torch.float32, q.device)
    # TMA reads from 16-byte-aligned bases
    q, k, v, do = (x if x.data_ptr() % 16 == 0 else x.clone()
                   for x in (q, k, v, do))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    d_rows = torch.empty((bh, t), dtype=torch.float32, device=q.device)
    lib = _library()
    with torch.cuda.device(q.device):
        err = lib.flash_attention_bwd(
            d, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), d_rows.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), bh, t, s, 1.0 / math.sqrt(d),
            int(causal), _build.stream_of(q))
    _build.check_launch(lib, "flash_attention_bwd", err)
    return dq, dk, dv
