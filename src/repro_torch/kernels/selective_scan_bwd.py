"""Build and binding of the hand-written CUDA ``selective_scan_bwd``
kernel.

The kernel (``csrc/selective_scan_bwd.cu``) is the gradient of the
Mamba-1 recurrence the ``selective_scan`` kernel computes, chunk-parallel:
T is cut into chunks of 32 steps; each chunk's local forward and reverse
states are summarised at once, a walk over the chunks gives each chunk's
entry state and incoming gradient, and every chunk then recomputes its
states and runs the reverse recurrence at once.  The sums over channels
and over the batch and chunks go through per-block partials in a fixed
order (no float atomics), so every run gives the same bits.  The reference
has no backward kernel (it differentiates the jnp scan).  Built and
loaded by ``build.py`` at first use; nothing here runs when the module is
imported.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build as _build

SOURCE = _build.CSRC / "selective_scan_bwd.cu"
NVCC_FLAGS = _build.BASE_FLAGS
MAX_STATE = 16


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load(SOURCE, NVCC_FLAGS)
    lib.selective_scan_bwd.argtypes = [ctypes.c_void_p] * 19 + [
        ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.selective_scan_bwd.restype = ctypes.c_int
    lib.selective_scan_bwd_scratch.argtypes = [ctypes.c_int] * 4 + [
        ctypes.POINTER(ctypes.c_longlong)]
    lib.selective_scan_bwd_scratch.restype = ctypes.c_int
    return lib


def launch(xi, dt, bmat, cmat, a, h0, dy, dh_last):
    """One backward call (four kernel launches) on the current CUDA stream.
    All float32: ``xi``, ``dt``, ``dy`` [B, T, I], ``bmat``, ``cmat``
    [B, T, S], ``a`` [I, S], ``h0``, ``dh_last`` [B, I, S].  Returns (dxi,
    ddt, dB, dC, da, dh0) in the inputs' shapes."""
    if xi.device.type != "cuda":
        raise ValueError(f"selective_scan_bwd kernel needs CUDA tensors, got "
                         f"{xi.device}")
    if xi.dim() != 3 or a.dim() != 2:
        raise ValueError("xi must be [B, T, I] and a [I, S]")
    b, t, i = xi.shape
    s = a.shape[1]
    if not 1 <= s <= MAX_STATE:
        raise ValueError(f"state width {s} is outside 1..{MAX_STATE}")
    if t == 0:
        raise ValueError("selective_scan_bwd needs T >= 1")
    dev, f32 = xi.device, torch.float32
    for name, x, shape in (
            ("xi", xi, (b, t, i)), ("dt", dt, (b, t, i)),
            ("bmat", bmat, (b, t, s)), ("cmat", cmat, (b, t, s)),
            ("a", a, (i, s)), ("h0", h0, (b, i, s)), ("dy", dy, (b, t, i)),
            ("dh_last", dh_last, (b, i, s))):
        _build.check_tensor(name, x, shape, f32, dev)
    lib = _library()
    sizes = (ctypes.c_longlong * 3)()
    _build.check_launch(lib, "selective_scan_bwd",
                        lib.selective_scan_bwd_scratch(b, t, i, s, sizes))
    # the chunks' entry states and incoming gradients (the latter then the
    # lanes' parts of da), the dB / dC partials, the chunks' sums of dt
    scratch = (torch.empty(sizes[0], dtype=f32, device=dev),
               torch.empty(sizes[0], dtype=f32, device=dev),
               torch.empty(sizes[2], dtype=f32, device=dev),
               torch.empty(sizes[1], dtype=f32, device=dev),
               torch.empty(sizes[1], dtype=f32, device=dev))
    outs = (torch.empty_like(xi), torch.empty_like(dt), torch.empty_like(bmat),
            torch.empty_like(cmat), torch.empty_like(a), torch.empty_like(h0))
    with torch.cuda.device(dev):
        err = lib.selective_scan_bwd(
            *(x.data_ptr() for x in (xi, dt, bmat, cmat, a, h0, dy, dh_last)),
            *(x.data_ptr() for x in outs),
            *(x.data_ptr() for x in scratch),
            b, t, i, s, _build.stream_of(xi))
    _build.check_launch(lib, "selective_scan_bwd", err)
    return outs
