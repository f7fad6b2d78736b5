"""Build and load of the port's hand-written CUDA kernels.

Each kernel source under ``csrc/`` is compiled with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, named after a
hash of the source, the shared headers and the flags, under
``build/repro_torch/`` at the repository root, at first use; it is loaded
with ``ctypes``.  The
compiler's ``-Xptxas -v`` report (registers, spills) is kept beside the
library.  Nothing here runs when the module is imported.
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

CSRC = Path(__file__).resolve().parent / "csrc"

#: the flags every kernel library is built with
BASE_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def build_dir() -> Path:
    """``build/repro_torch`` at the root of the repository holding ``src``."""
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def library_path(source: Path, flags: tuple[str, ...]) -> Path:
    """Where the library built from ``source`` with ``flags`` lives: named
    after a hash of the source, every header (``*.cuh``) beside it and the
    flags, so that an edit to a shared header rebuilds its users."""
    h = hashlib.sha256(source.read_bytes())
    for header in sorted(source.parent.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(flags).encode())
    return build_dir() / f"lib{source.stem}-{h.hexdigest()[:16]}.so"


def nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin``, ``/usr/local/cuda/bin`` or
    ``PATH``."""
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (os.path.join(cuda_home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked under $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "PATH); the port's kernels are built from source at first use")


def build(source: Path, flags: tuple[str, ...]) -> Path:
    """Compile ``source`` unless the library for this source and these
    flags exists.  A concurrent build is safe: each writes a temporary
    file and renames it into place."""
    lib = library_path(source, flags)
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=lib.parent)
    os.close(fd)
    try:
        proc = subprocess.run(
            [nvcc(), *flags, "-o", tmp, str(source)],
            capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) building {source}:\n"
                f"{proc.stdout}\n{proc.stderr}")
        Path(str(lib) + ".ptxas.txt").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib


def ptxas_report(source: Path, flags: tuple[str, ...]) -> str:
    """The compiler's resource report of the built library."""
    return Path(str(build(source, flags)) + ".ptxas.txt").read_text()


@functools.cache
def load(source: Path, flags: tuple[str, ...]) -> ctypes.CDLL:
    """The built library, loaded once per process."""
    return ctypes.CDLL(str(build(source, flags)))


def stream_of(t) -> int:
    """The handle of the current CUDA stream on ``t``'s device."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def check_launch(lib: ctypes.CDLL, kernel: str, err: int) -> None:
    """Raise when a launch returned a CUDA error code (every library
    exports ``<stem>_error_string``)."""
    if err != 0:
        name = getattr(lib, f"{kernel}_error_string")
        name.argtypes = [ctypes.c_int]
        name.restype = ctypes.c_char_p
        raise RuntimeError(
            f"{kernel} kernel launch failed: {name(err).decode()} ({err})")


def check_tensor(name: str, t, shape: tuple, dtype, device) -> None:
    """Raise unless ``t`` lies on ``device`` with ``dtype`` and ``shape``,
    contiguous."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
