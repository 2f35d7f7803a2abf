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

A kernel launches on the runtime's current device.  Every wrapper takes
its stream from :func:`stream_of` of its first tensor, which raises unless
that tensor lies on the current card: a rank whose state lies on
``cuda:1`` while ``cuda:0`` is current is refused, never launched on the
wrong card (``parallel.make_mesh`` makes the rank's card current).
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

__all__ = ["build", "call", "ptr", "stream_of", "check_cuda", "check_batch", "check_unbatched",
           "check_no_grad",
           "count_launch", "STORAGE", "elem_bytes", "MAX_BATCH"]

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
#: the storage types of f, g and h that the kernels take (``check_cuda``)
STORAGE = (torch.float32, torch.bfloat16)


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
    """The current stream of ``t``'s card, for the launch of a kernel on
    ``t``; raises unless that card is the current device, on which the
    kernel would launch."""
    current = torch.cuda.current_device()
    if t.device.index not in (None, current):
        raise RuntimeError(
            f"a kernel launches on the current card (cuda:{current}), but its tensor lies on "
            f"{t.device}: make that card current (torch.cuda.set_device, as "
            "parallel.make_mesh does for a rank)")
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def check_cuda(name: str, t: torch.Tensor, dtype, shape) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` (or of
    one of a tuple of dtypes, e.g. ``STORAGE``) and ``shape``: what the
    kernels take."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype not in (dtype if isinstance(dtype, tuple) else (dtype,)):
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")


#: batch elements a launch takes: its grid holds a copy of the one-element
#: grid an element on gridDim.y (at most 65535), or on gridDim.z with the
#: element's blocks along z (see :func:`check_batch`)
MAX_BATCH = 65535


def check_batch(name: str, B: int, slab: bool = False, zblocks: int = 1) -> None:
    """Raise unless a launch takes a batch of ``B`` elements: 1 to
    ``MAX_BATCH``, ``B * zblocks`` within gridDim.z where the kernel folds
    the batch into it beside its ``zblocks`` blocks along z, and 1 for a
    slab form (one element a rank, ROADMAP A12)."""
    if slab and B != 1:
        raise NotImplementedError(
            f"{name}: the slab forms step one batch element a rank, got {B} (ROADMAP A12 "
            "slice 7b: the slab forms at more than one batch element a rank; such a rank "
            "part steps on the block route, parallel/step3d.py:on_slabs)")
    if not 1 <= B * zblocks <= MAX_BATCH:
        raise ValueError(f"{name}: a launch takes 1 to {MAX_BATCH // zblocks} batch elements "
                         f"here ({zblocks} blocks along z an element), got {B}")


def check_unbatched(name: str, B: int) -> None:
    """Raise for a batch of more than one element at a kernel without a batch
    form (B1, B3, B10b: no batched route of the port launches them; B10a
    has its batch form since the block route's psi route runs it)."""
    if B != 1:
        raise NotImplementedError(
            f"{name}: a batch of {B} elements is not ported (ROADMAP A12 slice 8: the batch "
            "forms of B1, B3 and B10b); a batch steps on the routes of B2, B4, B5, B6, "
            "B8a, B8b, B9, B10a and B11b")


def check_slab_clamp(name: str, clamp, Z: int, min_planes: int) -> None:
    """Raise unless ``clamp`` is a slab form's z clamp on a slab of ``Z``
    planes: -1 or 1 below, Z or Z-2 above, ``min_planes`` or more planes."""
    if (clamp[0] not in (-1, 1) or clamp[1] not in (Z - 2, Z) or Z < min_planes
            or clamp[0] > clamp[1]):
        raise ValueError(f"{name}: slab clamp (-1 or 1, {Z - 2} or {Z}) on a slab of "
                         f"{min_planes} or more planes, got {tuple(clamp)} on {Z}")


def check_no_grad(name: str, *tensors) -> None:
    """Raise where autograd would record a launch of the kernel ``name``:
    grad is enabled and one of ``tensors`` (None allowed) requires it.
    The kernels run outside autograd (ctypes), so their outputs carry no
    ``grad_fn``: a loss taken through them would silently leave out their
    part of the gradient.  The plain versions stay differentiable."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: an input requires grad, and the CUDA kernel has no backward; "
            "for gradients step on the plain PyTorch versions (plain=True, or "
            "device='cpu'), as the JAX package's use_pallas=False"
        )


def count_launch(wrapper, bf16: bool, form: str | None = None, batch: int = 1) -> None:
    """One more launch of ``wrapper``'s kernel: ``wrapper.launches`` counts
    every launch, ``wrapper.launches_bf16`` those of its bfloat16-storage
    instance, ``wrapper.launches_<form>`` those of a named form (B1's
    ``psi``, B3's ``box``; a tuple names several, as B11b's ``slab`` and
    ``emit``), and ``wrapper.launches_batch`` those of a batch of more than
    one element (``batch``), one launch for the whole batch."""
    wrapper.launches += 1
    if bf16:
        wrapper.launches_bf16 += 1
    if batch > 1:
        wrapper.launches_batch += 1
    for name in (form,) if isinstance(form, str) else form or ():
        setattr(wrapper, f"launches_{name}", getattr(wrapper, f"launches_{name}") + 1)


def elem_bytes(t: torch.Tensor) -> int:
    """Bytes an element of the distribution ``t`` takes in the kernels: 2
    in bfloat16 storage, else 4 (a cost counts float32 for the float64 the
    plain versions also take)."""
    return 2 if t.dtype == torch.bfloat16 else 4
