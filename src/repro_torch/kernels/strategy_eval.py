"""Build and binding of the hand-written CUDA ``strategy_eval`` kernel.

The kernel (``csrc/strategy_eval.cu``) evaluates the closed-form cost model
over a ``[jobs, candidates]`` grid: every candidate row under every
operator and all 8 mapping strategies, the per-operator argmin, the
count-weighted totals, the area penalty and the bandwidth rule -- the
engine's batched ``cost_model.job_objective``.  It replaces the Pallas
TPU kernel of the reference (``repro/kernels/strategy_eval.py``).  Two
lanes take a candidate, one half of the 8 strategies each, and every term
the strategies share is computed once.

The source is compiled and loaded by the shared helper (``build.py``) at
first use.  Nothing here runs when the module is imported.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.cost_model import JobParams
from repro_torch.kernels import build as _build

SOURCE = _build.CSRC / "strategy_eval.cu"
#: per-job constants the kernel reads: 11 macro, 12 tech, 8 mask, the
#: objective code and the area budget (the layout of ``Param`` in the source)
NPARAM = 33
#: per-job terms the kernel derives once per block and keeps after the
#: constants (cyc_c and cyc_u for REV = 0 and 1, the clock in Hz)
NDERIVED = 5
#: IEEE division (no fast math) and no FMA contraction keep the kernel's
#: rounding equal to the plain version's
NVCC_FLAGS = _build.BASE_FLAGS + ("-fmad=false",)
#: the kernel stages a job's operator rows in default (48 KB) shared memory
MAX_SHARED_BYTES = 48 * 1024

_SYMBOLS = {torch.float32: "strategy_eval_f32",
            torch.float64: "strategy_eval_f64"}


def library_path():
    """Where the library built from the current source and flags lives."""
    return _build.library_path(SOURCE, NVCC_FLAGS)


def build():
    """Compile the kernel unless the library for this source exists."""
    return _build.build(SOURCE, NVCC_FLAGS)


def ptxas_report() -> str:
    """The compiler's resource report of the built library."""
    return _build.ptxas_report(SOURCE, NVCC_FLAGS)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load(SOURCE, NVCC_FLAGS)
    for sym in _SYMBOLS.values():
        fn = getattr(lib, sym)
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [
            ctypes.c_double, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.strategy_eval_nparam.restype = ctypes.c_int
    lib.strategy_eval_nderived.restype = ctypes.c_int
    if (lib.strategy_eval_nparam(), lib.strategy_eval_nderived()) != (
            NPARAM, NDERIVED):
        raise RuntimeError("kernel parameter layout does not match NPARAM "
                           "and NDERIVED")
    return lib


def pack_params(job: JobParams) -> torch.Tensor:
    """The kernel's per-job constant rows [J, NPARAM] from batched
    ``JobParams`` (macro, tech, strategy mask, objective code, budget)."""
    cols = [*job.macro, *job.tech]
    like = job.ops
    return torch.cat([
        torch.stack([torch.as_tensor(c, dtype=like.dtype, device=like.device)
                     for c in cols], dim=1),
        job.allowed.to(like.dtype),
        torch.stack([job.obj_code.to(like.dtype),
                     job.area_budget.to(like.dtype)], dim=1),
    ], dim=1).contiguous()


def launch(cand: torch.Tensor, ops: torch.Tensor, params: torch.Tensor,
           penalty_scale: float, *, totals: bool = False):
    """One kernel launch on the current CUDA stream.

    ``cand`` [J, C, 6], ``ops`` [J, P, 5], ``params`` [J, NPARAM], all of
    one float dtype (float32 or float64) on one CUDA device.  Returns the
    objective [J, C]; with ``totals`` also the total latency and energy
    [J, C] and the per-operator strategy index [J, C, P] (int32).
    """
    if cand.device.type != "cuda":
        raise ValueError(f"strategy_eval kernel needs CUDA tensors, got "
                         f"{cand.device}")
    if cand.dtype not in _SYMBOLS:
        raise TypeError(f"strategy_eval kernel takes float32 or float64, got "
                        f"{cand.dtype}")
    if cand.dim() != 3 or ops.dim() != 3:
        raise ValueError("cand must be [J, C, 6] and ops [J, P, 5]")
    J, C, P = cand.shape[0], cand.shape[1], ops.shape[1]
    _build.check_tensor("cand", cand, (J, C, 6), cand.dtype, cand.device)
    _build.check_tensor("ops", ops, (J, P, 5), cand.dtype, cand.device)
    _build.check_tensor("params", params, (J, NPARAM), cand.dtype, cand.device)
    if J > 65535:
        raise ValueError(f"at most 65535 jobs per launch, got {J}")
    if (NPARAM + NDERIVED + 5 * P) * cand.element_size() > MAX_SHARED_BYTES:
        raise ValueError(f"{P} operator rows exceed the kernel's shared memory")
    obj = torch.empty((J, C), dtype=cand.dtype, device=cand.device)
    lat = en = idx = None
    if totals:
        lat = torch.empty_like(obj)
        en = torch.empty_like(obj)
        idx = torch.empty((J, C, P), dtype=torch.int32, device=cand.device)
    ptr = lambda t: None if t is None else t.data_ptr()
    lib = _library()
    with torch.cuda.device(cand.device):
        stream = torch.cuda.current_stream(cand.device).cuda_stream
        err = getattr(lib, _SYMBOLS[cand.dtype])(
            ptr(cand), ptr(ops), ptr(params), ptr(obj), ptr(lat), ptr(en),
            ptr(idx), J, C, P, float(penalty_scale), stream)
    _build.check_launch(lib, "strategy_eval", err)
    return (obj, lat, en, idx) if totals else obj
