"""Build, load and call the port's CUDA kernels.

Each of ``csrc/*.cu`` (with the shared ``csrc/common.cuh``) is compiled
by its own ``nvcc`` process for ``sm_90a``, all started together, and one
more ``nvcc`` call links the objects into one shared library with a plain C
interface, at first use, into ``build/torch_kernels/`` at the repository
root (listed in ``.gitignore``), and loaded with ``ctypes``.  The file name
carries a hash of the sources and flags, so an edited source is rebuilt.
Nothing here runs at import time: importing the package needs neither a GPU
nor ``nvcc``.

Every C entry point returns ``cudaGetLastError()`` after its launch;
:func:`call` raises on a non-zero code, so a refused launch never passes
silently.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

__all__ = ["build", "call", "ptr", "stream_of", "check_cuda"]

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: the port's CUDA kernels are compiled at first "
            "use and need the CUDA toolkit (nvcc on PATH or /usr/local/cuda)"
        )
    return path


def build() -> Path:
    """Compile ``csrc/*.cu`` into one library unless it is built already,
    and return its path.  The compilers' output (registers and spills per
    kernel) lands beside it as ``.log``.  Raises with the compiler's message
    if the build fails."""
    sources = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode() + src.read_bytes())
    target = BUILD_DIR / f"lbm_kernels-{h.hexdigest()[:16]}.so"
    if target.exists():
        return target
    # objects and the library go to temporary names, so a cut-off build
    # leaves no library behind
    objdir = BUILD_DIR / f"obj-{h.hexdigest()[:16]}.{os.getpid()}"
    objdir.mkdir(parents=True, exist_ok=True)
    objs = [objdir / (src.stem + ".o") for src in sources]
    procs = [
        subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src, obj in zip(sources, objs)
    ]
    log, failed = [], False
    for src, proc in zip(sources, procs):
        out = proc.communicate()[0]
        log.append(f"== {src.name}\n{out}")
        failed |= proc.returncode != 0
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    if not failed:
        link = subprocess.run(
            [_nvcc(), *ARCH, "-shared", "-o", str(tmp), *map(str, objs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        log.append(f"== link\n{link.stdout}")
        failed = link.returncode != 0
    target.with_suffix(".log").write_text("".join(log))
    shutil.rmtree(objdir, ignore_errors=True)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "".join(log))
    os.replace(tmp, target)
    return target


def _library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.lbm_error_string.argtypes = [ctypes.c_int]
            lib.lbm_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def call(fn_name: str, *args) -> None:
    """Call the C entry point ``fn_name`` and raise on a CUDA error.

    Arguments are passed as given: pointers and the stream as
    ``ctypes.c_void_p`` (see :func:`ptr`), integers as ``ctypes.c_int``,
    floats as ``ctypes.c_double``."""
    lib = _library()
    fn = getattr(lib, fn_name)
    fn.restype = ctypes.c_int
    err = fn(*args)
    if err != 0:
        msg = lib.lbm_error_string(err).decode()
        raise RuntimeError(f"{fn_name}: CUDA error {err} ({msg})")


def ptr(t: torch.Tensor | None) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def stream_of(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def check_cuda(name: str, t: torch.Tensor, dtype, shape) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` and
    ``shape``: what the kernels take."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
