"""Build and binding of the hand-written CUDA ``adamw`` kernels: the
global-norm clip and AdamW update of every leaf of a training step.

The kernels (``csrc/adamw.cu``) work on one table of leaves: a row of 8
int64 a leaf (its four base pointers, its element count, its first chunk,
its decay flag and whether its bases are 16-byte aligned), built here on
the host and copied to the device from pinned memory on the current
stream, never by a synchronous copy.  A leaf is cut into chunks of
:data:`CHUNK` elements, one block a chunk.  :func:`chunk_spans` is the
kernels' own walk over the chunks, in numpy, so the CPU tests can show
that it covers every element once.  Built and loaded by ``build.py`` at
first use; nothing here runs when the module is imported.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels import build as _build

SOURCE = _build.CSRC / "adamw.cu"
NVCC_FLAGS = _build.BASE_FLAGS

#: elements a chunk (a block's work; a multiple of the float4 width): the
#: ``CHUNK`` that ``csrc/adamw.cu`` is compiled with
CHUNK = 1 << 16
#: the columns of a table row
FIELDS = ("p", "g", "m", "v", "n", "chunk0", "decay", "vec")
#: the kernel's scalars, in the order it takes them
HYPER = ("lr", "b1", "omb1", "b2", "omb2", "b1c", "b2c", "eps", "wd", "clip",
         "clip_floor")
#: the clip's floor on the norm (the loop's ``torch.clamp(gnorm, min=...)``)
CLIP_FLOOR = 1e-12


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load(SOURCE, NVCC_FLAGS)
    lib.adamw_sumsq.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                ctypes.c_longlong, ctypes.c_void_p,
                                ctypes.c_void_p, ctypes.c_void_p]
    lib.adamw_norm.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                               ctypes.c_void_p]
    lib.adamw_apply.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                ctypes.c_longlong, ctypes.c_void_p,
                                ctypes.POINTER(ctypes.c_float),
                                ctypes.c_void_p]
    for fn in (lib.adamw_sumsq, lib.adamw_norm, lib.adamw_apply):
        fn.restype = ctypes.c_int
    return lib


def table_rows(pointers, sizes, decay) -> np.ndarray:
    """The table [L, 8] int64 of leaves with base ``pointers`` (p, g, m, v;
    0 where absent), element counts ``sizes`` and ``decay`` flags: a leaf's
    first chunk is the count of the chunks of the leaves before it
    (ceil(n / CHUNK) each, none for an empty leaf), and it is vectorised
    when all its present bases are 16-byte aligned."""
    rows = np.zeros((len(sizes), len(FIELDS)), np.int64)
    if not len(sizes):
        return rows
    ptrs = np.asarray(pointers, np.uint64).reshape(len(sizes), 4)
    n = np.asarray(sizes, np.int64)
    chunks = -(-n // CHUNK)
    rows[:, :4] = ptrs.view(np.int64)
    rows[:, 4] = n
    rows[1:, 5] = np.cumsum(chunks)[:-1]
    rows[:, 6] = np.asarray(decay, bool)
    rows[:, 7] = (ptrs % 16 == 0).all(1)
    return rows


def total_chunks(rows: np.ndarray) -> int:
    """The chunks of a table: the grid of the kernels that take one block a
    chunk."""
    if not len(rows):
        return 0
    return int(rows[-1, 5] + -(-rows[-1, 4] // CHUNK))


def chunk_spans(rows: np.ndarray) -> dict:
    """What each block of a chunked launch takes, as the kernels compute
    it: arrays over the chunks of the leaf (the last row whose first chunk
    is at most the chunk's index), its first element, its end, and the
    end of its float4 part (the first element where a vectorised leaf
    leaves float4 for its scalar tail; the first element for a scalar
    leaf)."""
    c = np.arange(total_chunks(rows), dtype=np.int64)
    leaf = np.searchsorted(rows[:, 5], c, side="right") - 1
    start = (c - rows[leaf, 5]) * CHUNK
    end = np.minimum(start + CHUNK, rows[leaf, 4])
    vec_end = np.where(rows[leaf, 7] != 0, start + 4 * ((end - start) // 4),
                       start)
    return {"leaf": leaf, "start": start, "end": end, "vec_end": vec_end}


def _check(name: str, t: torch.Tensor, device, numel: int) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"the adamw kernels take float32 parameters, "
                        f"gradients and moments; {name} is {t.dtype}")
    if t.numel() != numel:
        raise ValueError(f"{name} has {t.numel()} elements, its leaf {numel}")


class LeafTable:
    """The leaves of one step: the tensors (local shards) and, on the card,
    their table on the device.  ``grads`` alone serve the norm; ``params``,
    ``ms``, ``vs`` and ``decay`` the update as well.  On the card every
    tensor is float32 and contiguous: a gradient that is not is made so
    (one copy), any other that is not raises."""

    def __init__(self, grads, params=None, ms=None, vs=None, decay=None):
        self.grads = list(grads)
        self.params = None if params is None else list(params)
        self.ms = None if ms is None else list(ms)
        self.vs = None if vs is None else list(vs)
        self.decay = [False] * len(self.grads) if decay is None else \
            [bool(d) for d in decay]
        self.leaves = len(self.grads)
        self.elements = sum(g.numel() for g in self.grads)
        self.device = self.grads[0].device if self.grads else \
            torch.device("cpu")
        self.rows = self.dev = None
        self.chunks = 0
        if self.device.type == "cuda":
            self._upload()

    def _upload(self) -> None:
        full = self.params is not None
        if full and not (len(self.params) == len(self.ms) == len(self.vs)
                         == len(self.decay) == self.leaves):
            raise ValueError("a table needs one parameter, gradient, moment "
                             "pair and decay flag a leaf")
        ptrs = []
        for i, g in enumerate(self.grads):
            _check(f"gradient {i}", g, self.device, g.numel())
            if not g.is_contiguous():
                self.grads[i] = g = g.contiguous()
            if full:
                p, m, v = self.params[i], self.ms[i], self.vs[i]
                for name, t in (("parameter", p), ("m", m), ("v", v)):
                    _check(f"{name} {i}", t, self.device, g.numel())
                    if not t.is_contiguous():
                        raise ValueError(f"{name} {i} must be contiguous")
                ptrs.append((p.data_ptr(), g.data_ptr(), m.data_ptr(),
                             v.data_ptr()))
            else:
                ptrs.append((0, g.data_ptr(), 0, 0))
        self.rows = table_rows(ptrs, [g.numel() for g in self.grads],
                               self.decay)
        self.chunks = total_chunks(self.rows)
        host = torch.from_numpy(self.rows).pin_memory()
        self.dev = host.to(self.device, non_blocking=True)


def sumsq(table: LeafTable) -> tuple[torch.Tensor, int]:
    """(each leaf's fp32 sum of squares [L], kernel launches)."""
    sums = torch.empty(table.leaves, dtype=torch.float32, device=table.device)
    partial = torch.empty(max(table.chunks, 1), dtype=torch.float32,
                          device=table.device)
    lib = _library()
    with torch.cuda.device(table.device):
        err = lib.adamw_sumsq(table.dev.data_ptr(), table.leaves,
                              table.chunks, partial.data_ptr(),
                              sums.data_ptr(), _build.stream_of(sums))
    _build.check_launch(lib, "adamw", err)
    return sums, (table.chunks > 0) + (table.leaves > 0)


def norm(sums: torch.Tensor) -> torch.Tensor:
    """sqrt of the sums added in order, a 0-dim fp32 tensor (one launch)."""
    _build.check_tensor("sums", sums, (sums.numel(),), torch.float32,
                        sums.device)
    out = torch.empty((), dtype=torch.float32, device=sums.device)
    lib = _library()
    with torch.cuda.device(sums.device):
        err = lib.adamw_norm(sums.data_ptr(), sums.numel(), out.data_ptr(),
                             _build.stream_of(sums))
    _build.check_launch(lib, "adamw", err)
    return out


def hyper(*, lr: float, b1c: float, b2c: float, b1: float, b2: float,
          eps: float, weight_decay: float, grad_clip: float) -> dict:
    """The kernel's scalars as Python numbers, before their one rounding to
    fp32: ``1 - b1`` and ``1 - b2`` are taken in double, as the loop's
    Python arithmetic does."""
    return {"lr": lr, "b1": b1, "omb1": 1 - b1, "b2": b2, "omb2": 1 - b2,
            "b1c": b1c, "b2c": b2c, "eps": eps, "wd": weight_decay,
            "clip": grad_clip, "clip_floor": CLIP_FLOOR}


def apply(table: LeafTable, gnorm: torch.Tensor, scalars: dict) -> int:
    """The clipped update of every leaf of ``table``, in place, from the
    global norm ``gnorm`` (0-dim fp32 on the device, read there); returns
    the kernel launches."""
    if table.params is None:
        raise ValueError("the update needs a table of parameters, gradients "
                         "and moments")
    _build.check_tensor("gnorm", gnorm, (), torch.float32, table.device)
    vals = (ctypes.c_float * len(HYPER))(*(scalars[k] for k in HYPER))
    lib = _library()
    with torch.cuda.device(table.device):
        err = lib.adamw_apply(table.dev.data_ptr(), table.leaves,
                              table.chunks, gnorm.data_ptr(), vals,
                              _build.stream_of(gnorm))
    _build.check_launch(lib, "adamw", err)
    return int(table.chunks > 0 and table.leaves > 0)
