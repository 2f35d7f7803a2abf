"""B8a/B8b: stream + bounce-back of one distribution, with its raw moments
(B8a) or its macro fields (B8b).

Replace the TPU kernels ``lbm_ferrofluid_tpu/ops/pallas/stream3d.py:
stream_bounce_moments`` (:164) and ``stream_bounce_macro`` (:231).  The CUDA
source ``csrc/stream3d.cu`` has one entry point for each, as the JAX package
calls them separately: one thread per cell pulls 19 values with periodic
wrap on every axis, bounces them at obstacles and writes them with the
moments, or with rho and vel (frozen at obstacles) and density.  A call is
one launch.  The plain versions are ``ops/stream.py:stream_bounce_moments``
and ``stream_bounce_macro``.

Both take a batch ``[B, 19, Z, Y, X]`` in one launch (a row of blocks an
element; each element's bits those of a call on it alone); the slab forms
one element.

Both take f in float32 or bfloat16 (the JAX package's turbo mode), and
write f_post in f's type: streaming and bounce-back permute values, so a
bfloat16 f_post holds the input's bits; the moments and macros are float32.

Bound on an H100: bytes, 169 B per cell (B8a) and 173 B per cell plus 16 B
per obstacle cell (B8b), 93 B and 97 B in bfloat16 storage; see
:func:`cost_moments` and :func:`cost_macro`.

Their slab forms (``ghosts=``: the TPU kernels' ``up_ghost``/``dn_ghost``,
for a z-slab of a domain decomposed along z over ranks,
``parallel/step3d.py``) take the neighbours' edge planes ``ghosts = (lo,
hi)``, [1, 5, 1, Y, X] each, as ``fused_step.ghost_planes`` cuts them:
channels 9:14 of the plane below the slab and 14:19 of the plane above,
which plane 0's z-1 and plane Z-1's z+1 pulls read instead of the wrap.
One launch (``launches_slab``); the plain versions stream the slab
extended by those planes (``fused_step.extend_ghosts``) and keep its
planes; :func:`cost_slab` adds the ghost planes' reads.
"""

from __future__ import annotations

import ctypes

import torch

from ...lattice import D3Q19
from ...utils.types import CellType
from ..stream import stream_bounce_macro as _macro_plain
from ..stream import stream_bounce_moments as _moments_plain
from ._lib import (STORAGE, call, check_batch, check_cuda, check_no_grad, count_launch,
                   elem_bytes, ptr, stream_of)
from .fused_step import extend_ghosts, repeat_ends

__all__ = [
    "stream_bounce_moments", "stream_bounce_moments_plain", "stream_bounce_macro",
    "stream_bounce_macro_plain", "cost_moments", "cost_macro", "cost_slab",
]

TPU_KERNEL_MOMENTS = "lbm_ferrofluid_tpu/ops/pallas/stream3d.py:164"
TPU_KERNEL_MACRO = "lbm_ferrofluid_tpu/ops/pallas/stream3d.py:231"
CUDA_SOURCE = "lbm_ferrofluid_tpu_torch/csrc/stream3d.cu"


def cost_moments(f, flags) -> tuple[int, int]:
    """(bytes, flops) that a call on these inputs must move and do: f (in
    its storage type) and flags read and f_post, m0 and m1 written at every
    cell; 18 adds for m0 and 30 signed adds for m1."""
    fb = 19 * elem_bytes(f)
    return flags.numel() * (2 * fb + 1 + 16), flags.numel() * 48


def cost_macro(f, flags, rho_old, vel_old, **_) -> tuple[int, int]:
    """(bytes, flops): f (in its storage type) and flags read, f_post, rho,
    vel and density written at every cell, rho_old and vel_old read only
    at obstacles; the moments (48 flops), the density map (4) at every cell
    and vel (a divide and 3 multiplies) elsewhere."""
    n = flags.numel()
    n_obs = int((flags == int(CellType.OBSTACLE)).sum())
    fb = 19 * elem_bytes(f)
    return n * (2 * fb + 1 + 20) + 16 * n_obs, n * 52 + (n - n_obs) * 4


def cost_slab(cost_fn, f, *args, ghosts=None, **kw) -> tuple[int, int]:
    """``cost_fn`` (:func:`cost_moments` or :func:`cost_macro`) of the slab
    form: the ghost planes' 5 channels a side read once more."""
    nbytes, flops = cost_fn(f, *args, **kw)
    return nbytes + sum(t.numel() * elem_bytes(f) for t in ghosts), flops


def _extended(f, flags, ghosts, *fields):
    """The slab's f extended by its ghost planes and the other fields by
    their end planes (whose outputs are dropped)."""
    return (extend_ghosts(f, *ghosts), repeat_ends(flags), *(repeat_ends(x) for x in fields))


def _slab_planes(out):
    return tuple(x[:, :, 1:-1] for x in out)


def stream_bounce_moments_plain(f, flags, ghosts=None):
    """Plain PyTorch version of :func:`stream_bounce_moments`; the slab form
    streams f extended by its ghost planes and keeps the slab's planes."""
    if ghosts is not None:
        return _slab_planes(_moments_plain(D3Q19, *_extended(f, flags, ghosts)))
    return _moments_plain(D3Q19, f, flags)


def stream_bounce_macro_plain(f, flags, rho_old, vel_old, ghosts=None, *, c, rho_gas, rho_fluid,
                              density_gas, density_fluid):
    """Plain PyTorch version of :func:`stream_bounce_macro`; the slab form
    streams f extended by its ghost planes and keeps the slab's planes."""
    kw = dict(c=c, rho_gas=rho_gas, rho_fluid=rho_fluid, density_gas=density_gas,
              density_fluid=density_fluid)
    if ghosts is not None:
        return _slab_planes(_macro_plain(D3Q19, *_extended(f, flags, ghosts, rho_old, vel_old),
                                         **kw))
    return _macro_plain(D3Q19, f, flags, rho_old, vel_old, **kw)


def _check(f, flags, ghosts):
    B, Q, Z, Y, X = f.shape
    check_batch("f", B, ghosts is not None)
    check_cuda("f", f, STORAGE, (B, 19, Z, Y, X))
    check_cuda("flags", flags, torch.uint8, (B, 1, Z, Y, X))
    if ghosts is not None:
        for name, t in zip(("ghost_lo", "ghost_hi"), ghosts, strict=True):
            check_cuda(name, t, (f.dtype,), (1, 5, 1, Y, X))
    return B, Z, Y, X


def stream_bounce_moments(f, flags, ghosts=None):
    """f [B, 19, Z, Y, X] float32 or bfloat16, flags uint8 -> (f_post in
    f's type, m0 [B, 1, ...], m1 [B, 3, ...] float32), the B elements in
    one launch; with ``ghosts`` the slab form (module docstring, B = 1).
    CPU tensors take the plain version; CUDA tensors launch the kernel;
    anything else raises."""
    if f.device.type == "cpu":
        return stream_bounce_moments_plain(f, flags, ghosts)
    check_no_grad("stream_bounce_moments", f)
    B, Z, Y, X = _check(f, flags, ghosts)
    bf16 = f.dtype == torch.bfloat16
    f_post = torch.empty_like(f)
    m0 = torch.empty((B, 1, Z, Y, X), dtype=torch.float32, device=f.device)
    m1 = torch.empty((B, 3, Z, Y, X), dtype=torch.float32, device=f.device)
    lo, hi = ghosts or (None, None)
    call("lbm_stream_moments3d", ptr(f), ptr(flags), ptr(f_post), ptr(m0), ptr(m1),
         ctypes.c_int(B), ctypes.c_int(Z), ctypes.c_int(Y), ctypes.c_int(X), ctypes.c_int(bf16),
         ptr(lo), ptr(hi), stream_of(f))
    count_launch(stream_bounce_moments, bf16, None if ghosts is None else "slab", B)
    return f_post, m0, m1


def stream_bounce_macro(f, flags, rho_old, vel_old, ghosts=None, *, c, rho_gas, rho_fluid,
                        density_gas, density_fluid):
    """f [B, 19, Z, Y, X] float32 or bfloat16, flags uint8, rho_old [B, 1,
    ...], vel_old [B, 3, ...] float32 -> (f_post in f's type, rho, vel,
    density), the B elements in one launch; with ``ghosts`` the slab form
    (module docstring, B = 1).  CPU
    tensors take the plain version; CUDA tensors launch the kernel;
    anything else raises."""
    if f.device.type == "cpu":
        return stream_bounce_macro_plain(
            f, flags, rho_old, vel_old, ghosts, c=c, rho_gas=rho_gas, rho_fluid=rho_fluid,
            density_gas=density_gas, density_fluid=density_fluid,
        )
    check_no_grad("stream_bounce_macro", f, rho_old, vel_old)
    B, Z, Y, X = _check(f, flags, ghosts)
    check_cuda("rho_old", rho_old, torch.float32, (B, 1, Z, Y, X))
    check_cuda("vel_old", vel_old, torch.float32, (B, 3, Z, Y, X))
    f_post = torch.empty_like(f)
    rho, vel, den = torch.empty_like(rho_old), torch.empty_like(vel_old), torch.empty_like(rho_old)
    lo, hi = ghosts or (None, None)
    call("lbm_stream_macro3d", ptr(f), ptr(flags), ptr(rho_old), ptr(vel_old), ptr(f_post),
         ptr(rho), ptr(vel), ptr(den), ctypes.c_int(B), ctypes.c_int(Z), ctypes.c_int(Y),
         ctypes.c_int(X),
         *(ctypes.c_double(float(v))
           for v in (c, rho_gas, rho_fluid, density_gas, density_fluid)),
         ctypes.c_int(f.dtype == torch.bfloat16), ptr(lo), ptr(hi), stream_of(f))
    count_launch(stream_bounce_macro, f.dtype == torch.bfloat16,
                 None if ghosts is None else "slab", B)
    return f_post, rho, vel, den


stream_bounce_moments.launches = 0
stream_bounce_moments.launches_bf16 = 0
stream_bounce_moments.launches_slab = 0
stream_bounce_moments.launches_batch = 0
stream_bounce_macro.launches = 0
stream_bounce_macro.launches_bf16 = 0
stream_bounce_macro.launches_slab = 0
stream_bounce_macro.launches_batch = 0
