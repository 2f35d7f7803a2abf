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

Bound on an H100: bytes, 169 B per cell (B8a) and 173 B per cell plus 16 B
per obstacle cell (B8b); see :func:`cost_moments` and :func:`cost_macro`.
"""

from __future__ import annotations

import ctypes

import torch

from ...lattice import D3Q19
from ...utils.types import CellType
from ..stream import stream_bounce_macro as _macro_plain
from ..stream import stream_bounce_moments as _moments_plain
from ._lib import call, check_cuda, ptr, stream_of

__all__ = [
    "stream_bounce_moments", "stream_bounce_moments_plain", "stream_bounce_macro",
    "stream_bounce_macro_plain", "cost_moments", "cost_macro",
]

TPU_KERNEL_MOMENTS = "lbm_ferrofluid_tpu/ops/pallas/stream3d.py:164"
TPU_KERNEL_MACRO = "lbm_ferrofluid_tpu/ops/pallas/stream3d.py:231"
CUDA_SOURCE = "lbm_ferrofluid_tpu_torch/csrc/stream3d.cu"


def cost_moments(f, flags) -> tuple[int, int]:
    """(bytes, flops) that a call on these inputs must move and do: f and
    flags read and f_post, m0 and m1 written at every cell; 18 adds for m0
    and 30 signed adds for m1."""
    return flags.numel() * (76 + 1 + 76 + 16), flags.numel() * 48


def cost_macro(f, flags, rho_old, vel_old, **_) -> tuple[int, int]:
    """(bytes, flops): f and flags read, f_post, rho, vel and density
    written at every cell, rho_old and vel_old read only at obstacles; the
    moments (48 flops), the density map (4) at every cell and vel (a divide
    and 3 multiplies) elsewhere."""
    n = flags.numel()
    n_obs = int((flags == int(CellType.OBSTACLE)).sum())
    return n * (76 + 1 + 76 + 20) + 16 * n_obs, n * 52 + (n - n_obs) * 4


def stream_bounce_moments_plain(f, flags):
    """Plain PyTorch version of :func:`stream_bounce_moments`."""
    return _moments_plain(D3Q19, f, flags)


def stream_bounce_macro_plain(f, flags, rho_old, vel_old, *, c, rho_gas, rho_fluid,
                              density_gas, density_fluid):
    """Plain PyTorch version of :func:`stream_bounce_macro`."""
    return _macro_plain(
        D3Q19, f, flags, rho_old, vel_old, c=c, rho_gas=rho_gas, rho_fluid=rho_fluid,
        density_gas=density_gas, density_fluid=density_fluid,
    )


def _check(f, flags):
    B, Q, Z, Y, X = f.shape
    check_cuda("f", f, torch.float32, (1, 19, Z, Y, X))
    check_cuda("flags", flags, torch.uint8, (1, 1, Z, Y, X))
    return Z, Y, X


def stream_bounce_moments(f, flags):
    """f [1, 19, Z, Y, X] float32, flags uint8 -> (f_post, m0 [1, 1, ...],
    m1 [1, 3, ...]).  CPU tensors take the plain version; CUDA tensors
    launch the kernel; anything else raises."""
    if f.device.type == "cpu":
        return stream_bounce_moments_plain(f, flags)
    Z, Y, X = _check(f, flags)
    f_post = torch.empty_like(f)
    m0 = torch.empty((1, 1, Z, Y, X), dtype=f.dtype, device=f.device)
    m1 = torch.empty((1, 3, Z, Y, X), dtype=f.dtype, device=f.device)
    call("lbm_stream_moments3d", ptr(f), ptr(flags), ptr(f_post), ptr(m0), ptr(m1),
         ctypes.c_int(Z), ctypes.c_int(Y), ctypes.c_int(X), stream_of(f))
    stream_bounce_moments.launches += 1
    return f_post, m0, m1


def stream_bounce_macro(f, flags, rho_old, vel_old, *, c, rho_gas, rho_fluid,
                        density_gas, density_fluid):
    """f [1, 19, Z, Y, X] float32, flags uint8, rho_old [1, 1, ...], vel_old
    [1, 3, ...] -> (f_post, rho, vel, density).  CPU tensors take the plain
    version; CUDA tensors launch the kernel; anything else raises."""
    if f.device.type == "cpu":
        return stream_bounce_macro_plain(
            f, flags, rho_old, vel_old, c=c, rho_gas=rho_gas, rho_fluid=rho_fluid,
            density_gas=density_gas, density_fluid=density_fluid,
        )
    Z, Y, X = _check(f, flags)
    check_cuda("rho_old", rho_old, torch.float32, (1, 1, Z, Y, X))
    check_cuda("vel_old", vel_old, torch.float32, (1, 3, Z, Y, X))
    f_post = torch.empty_like(f)
    rho, vel, den = torch.empty_like(rho_old), torch.empty_like(vel_old), torch.empty_like(rho_old)
    call("lbm_stream_macro3d", ptr(f), ptr(flags), ptr(rho_old), ptr(vel_old), ptr(f_post),
         ptr(rho), ptr(vel), ptr(den), ctypes.c_int(Z), ctypes.c_int(Y), ctypes.c_int(X),
         *(ctypes.c_double(float(v))
           for v in (c, rho_gas, rho_fluid, density_gas, density_fluid)),
         stream_of(f))
    stream_bounce_macro.launches += 1
    return f_post, rho, vel, den


stream_bounce_moments.launches = 0
stream_bounce_macro.launches = 0
