"""ctypes bindings of the port's native host library: the C++ marching
tetrahedra extractor and the Tecplot writers.

Port of ``lbm_ferrofluid_tpu/native/__init__.py``, with its own copy of the
source (``lbmnative.cpp`` beside this file).  The library is built at first
use with ``g++ -O3 -shared -fPIC`` into ``build/torch_native/`` at the
repository root (listed in ``.gitignore``), under a name that carries a
hash of the source and flags; the compiler writes a temporary name, which
is then renamed into place, so processes that build at once leave one good
library.  :func:`available` is False only where no C++ compiler exists; a
compiler that fails on the source raises with its log.  The numpy paths
(``render/mesh.py:marching_tetrahedra_numpy``, the writers' Python loops in
``utils/io.py``) are the plain versions the native ones are held against.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

__all__ = ["available", "build", "marching_tetrahedra_native", "dump_2d_plt_native",
           "dump_3d_plt_native"]

SOURCE = Path(__file__).resolve().parent / "lbmnative.cpp"
BUILD_DIR = SOURCE.parents[2] / "build" / "torch_native"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _compiler() -> str | None:
    return shutil.which("g++") or shutil.which("c++")


def build() -> Path:
    """Compile ``lbmnative.cpp`` unless it is built already, and return the
    library's path.  Raises with the compiler's output if it fails."""
    cxx = _compiler()
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++ or c++ on PATH) to build the native library")
    digest = hashlib.sha256(" ".join(FLAGS).encode() + SOURCE.read_bytes()).hexdigest()[:16]
    target = BUILD_DIR / f"liblbmnative-{digest}.so"
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    out = subprocess.run([cxx, *FLAGS, str(SOURCE), "-o", str(tmp)], stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
    if out.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cxx} failed on {SOURCE.name}:\n{out.stdout}")
    os.replace(tmp, target)
    return target


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.mtetra_run.restype = ctypes.c_void_p
            lib.mtetra_run.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_float, ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int64),
            ]
            lib.mtetra_fill.restype = None
            lib.mtetra_fill.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
                                        ctypes.POINTER(ctypes.c_int64)]
            f32p, i64 = ctypes.POINTER(ctypes.c_float), ctypes.c_int64
            for fn, n_fields, n_axes in ((lib.dump_2d_plt, 3, 2), (lib.dump_3d_plt, 4, 3)):
                fn.restype = ctypes.c_int
                fn.argtypes = [ctypes.c_char_p, *[f32p] * n_fields, *[i64] * n_axes]
            _lib = lib
        return _lib


def available() -> bool:
    """Whether the native library can be used: builds it at first use;
    False only where no C++ compiler exists."""
    if _lib is None and _compiler() is None:
        return False
    _load()
    return True


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def marching_tetrahedra_native(volume: np.ndarray, level: float = 0.0):
    """C++ marching tetrahedra of a ``[D, H, W]`` volume (taken in float32)
    -> (verts ``[N, 3]`` float32, faces ``[M, 3]`` int64), the convention of
    ``render/mesh.py``."""
    lib = _load()
    vol = np.ascontiguousarray(volume, dtype=np.float32)
    D, H, W = vol.shape
    nv, nf = ctypes.c_int64(), ctypes.c_int64()
    handle = lib.mtetra_run(_f32p(vol), D, H, W, ctypes.c_float(level), ctypes.byref(nv),
                            ctypes.byref(nf))
    verts = np.empty((nv.value, 3), np.float32)
    faces = np.empty((nf.value, 3), np.int64)
    lib.mtetra_fill(handle, _f32p(verts), faces.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return verts, faces


def dump_2d_plt_native(filename: str, density, u, v) -> None:
    """Tecplot POINT dump of ``[H, W]`` fields (values as ``%g``)."""
    lib = _load()
    arrs = [np.ascontiguousarray(x, np.float32) for x in (density, u, v)]
    H, W = arrs[0].shape[-2:]
    if lib.dump_2d_plt(str(filename).encode(), *map(_f32p, arrs), H, W) != 0:
        raise OSError(f"dump_2d_plt failed for {filename}")


def dump_3d_plt_native(filename: str, density, u, v, w) -> None:
    """Tecplot POINT dump of ``[D, H, W]`` fields (values as ``%g``)."""
    lib = _load()
    arrs = [np.ascontiguousarray(x, np.float32) for x in (density, u, v, w)]
    D, H, W = arrs[0].shape[-3:]
    if lib.dump_3d_plt(str(filename).encode(), *map(_f32p, arrs), D, H, W) != 0:
        raise OSError(f"dump_3d_plt failed for {filename}")
