"""Build and binding of the hand-written CUDA ``strategy_eval`` kernel.

The kernel (``csrc/strategy_eval.cu``) evaluates the closed-form cost model
over a ``[jobs, candidates]`` grid: every candidate row under every
operator and all 8 mapping strategies, the per-operator argmin, the
count-weighted totals, the area penalty and the bandwidth rule -- the
engine's batched ``cost_model.job_objective``.  It replaces the Pallas
TPU kernel of the reference (``repro/kernels/strategy_eval.py``).

The source is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, named after a hash of the source and the flags,
under ``build/repro_torch/`` at the repository root, at first use; it is
loaded with ``ctypes``.  Nothing here runs when the module is imported.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from repro_torch.core.cost_model import JobParams

SOURCE = Path(__file__).resolve().parent / "csrc" / "strategy_eval.cu"
#: per-job constants the kernel reads: 11 macro, 12 tech, 8 mask, the
#: objective code and the area budget (the layout of ``Param`` in the source)
NPARAM = 33
#: IEEE division (no fast math) and no FMA contraction keep the kernel's
#: rounding equal to the plain version's
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
#: the kernel stages a job's operator rows in default (48 KB) shared memory
MAX_SHARED_BYTES = 48 * 1024

_SYMBOLS = {torch.float32: "strategy_eval_f32",
            torch.float64: "strategy_eval_f64"}


def build_dir() -> Path:
    """``build/repro_torch`` at the root of the repository holding ``src``."""
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def library_path() -> Path:
    """Where the library built from the current source and flags lives."""
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return build_dir() / f"libstrategy_eval-{digest[:16]}.so"


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (os.path.join(cuda_home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked under $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "PATH); the strategy_eval kernel is built from source at first use")


def build() -> Path:
    """Compile the kernel unless the library for this source exists.

    The compiler's ``-Xptxas -v`` report (registers, spills) is kept beside
    the library as ``<library>.ptxas.txt``.  A concurrent build is safe:
    each writes a temporary file and renames it into place.
    """
    lib = library_path()
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=lib.parent)
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
            capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) building {SOURCE}:\n"
                f"{proc.stdout}\n{proc.stderr}")
        Path(str(lib) + ".ptxas.txt").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib


def ptxas_report() -> str:
    """The compiler's resource report of the built library."""
    return Path(str(build()) + ".ptxas.txt").read_text()


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    for sym in _SYMBOLS.values():
        fn = getattr(lib, sym)
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [
            ctypes.c_double, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.strategy_eval_error_string.argtypes = [ctypes.c_int]
    lib.strategy_eval_error_string.restype = ctypes.c_char_p
    lib.strategy_eval_nparam.restype = ctypes.c_int
    if lib.strategy_eval_nparam() != NPARAM:
        raise RuntimeError("kernel parameter layout does not match NPARAM")
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


def _check(name: str, t: torch.Tensor, shape: tuple, dtype, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


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
    _check("cand", cand, (J, C, 6), cand.dtype, cand.device)
    _check("ops", ops, (J, P, 5), cand.dtype, cand.device)
    _check("params", params, (J, NPARAM), cand.dtype, cand.device)
    if J > 65535:
        raise ValueError(f"at most 65535 jobs per launch, got {J}")
    if (NPARAM + 5 * P) * cand.element_size() > MAX_SHARED_BYTES:
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
    if err != 0:
        raise RuntimeError(
            "strategy_eval kernel launch failed: "
            f"{lib.strategy_eval_error_string(err).decode()} ({err})")
    return (obj, lat, en, idx) if totals else obj
