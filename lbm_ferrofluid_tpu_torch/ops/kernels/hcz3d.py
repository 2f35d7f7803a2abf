"""B9: the HCZ LBGK collide of f and g with Guo forcing.

Replaces the TPU kernel ``lbm_ferrofluid_tpu/ops/pallas/hcz3d.py:
hcz_collide_fused`` (:142), which runs the f and g updates as two
``pallas_call``s because one tile of all inputs exceeded VMEM.  The CUDA
source ``csrc/hcz3d.cu`` updates both in one launch, one thread per cell,
out of place into a new f/g pair; non-fluid cells keep their streamed
values.  The per-cell collide is the capillogue's (``csrc/common.cuh``).
The plain version is ``ops/collide.py:hcz_collide``.  f and g may be
stored in bfloat16 (the JAX package's turbo mode): the kernel's bfloat16
instance widens them, collides in float32 and rounds f'/g' once, on the
store.

Bound on an H100: bytes, 305 B per cell plus 60 B per fluid cell (153 B
plus 60 B in bfloat16 storage; see :func:`cost`).
"""

from __future__ import annotations

import ctypes

import torch

from ...lattice import D3Q19
from ...utils.types import CellType
from ..collide import hcz_collide
from ._lib import (STORAGE, call, check_cuda, check_no_grad, count_launch, elem_bytes, ptr,
                   stream_of)

__all__ = ["hcz_collide_fused", "hcz_collide_fused_plain", "cost"]

TPU_KERNEL = "lbm_ferrofluid_tpu/ops/pallas/hcz3d.py:142"
CUDA_SOURCE = "lbm_ferrofluid_tpu_torch/csrc/hcz3d.cu"


def cost(f, g, rho, vel, density, pressure, flags, force, dfai, dprho, **_):
    """(bytes, flops) that a call on these inputs must move and do: f and g
    (in their storage type) read and written and flags read at every cell;
    rho, density, pressure,
    vel, force, dfai and dprho read only at fluid cells (other cells keep
    their streamed values); about 900 flops per fluid cell (feq, Gamma and
    two forcing updates over 19 channels, the axis factors and dot
    products)."""
    n = flags.numel()
    n_fluid = int((flags == int(CellType.FLUID)).sum())
    fg = 19 * (elem_bytes(f) + elem_bytes(g))
    return n * (2 * fg + 1) + 60 * n_fluid, 900 * n_fluid


def hcz_collide_fused_plain(f, g, rho, vel, density, pressure, flags, force, dfai,
                            dprho, *, tau_f, tau_g, dx=1.0, dt=1.0):
    """Plain PyTorch version of :func:`hcz_collide_fused`."""
    return hcz_collide(D3Q19, f, g, rho, vel, density, pressure, flags, force, dfai,
                       dprho, tau_f=tau_f, tau_g=tau_g, dx=dx, dt=dt)


def hcz_collide_fused(f, g, rho, vel, density, pressure, flags, force, dfai, dprho, *,
                      tau_f, tau_g, dx=1.0, dt=1.0):
    """Post-stream f, g [1, 19, Z, Y, X] float32 or bfloat16 (f', g' in the
    same type), the capillary stage's float32
    rho, density, pressure [1, 1, ...] and vel, force, dfai, dprho
    [1, 3, ...], flags uint8 -> (f', g').  CPU tensors take the plain
    version; CUDA tensors launch the kernel; anything else raises.  Inputs
    are not modified."""
    if f.device.type == "cpu":
        return hcz_collide_fused_plain(f, g, rho, vel, density, pressure, flags, force,
                                       dfai, dprho, tau_f=tau_f, tau_g=tau_g, dx=dx, dt=dt)
    check_no_grad("hcz_collide_fused", f, g, rho, vel, density, pressure, force, dfai, dprho)
    B, Q, Z, Y, X = f.shape
    check_cuda("f", f, STORAGE, (1, 19, Z, Y, X))
    check_cuda("g", g, (f.dtype,), (1, 19, Z, Y, X))
    for name, t in (("rho", rho), ("density", density), ("pressure", pressure)):
        check_cuda(name, t, torch.float32, (1, 1, Z, Y, X))
    for name, t in (("vel", vel), ("force", force), ("dfai", dfai), ("dprho", dprho)):
        check_cuda(name, t, torch.float32, (1, 3, Z, Y, X))
    check_cuda("flags", flags, torch.uint8, (1, 1, Z, Y, X))
    f_out, g_out = torch.empty_like(f), torch.empty_like(g)
    call("lbm_hcz_collide", ptr(f), ptr(g), ptr(flags), ptr(rho), ptr(vel), ptr(density),
         ptr(pressure), ptr(force), ptr(dfai), ptr(dprho), ptr(f_out), ptr(g_out),
         ctypes.c_int(Z), ctypes.c_int(Y), ctypes.c_int(X), ctypes.c_double(dx),
         ctypes.c_double(dt), ctypes.c_double(tau_f), ctypes.c_double(tau_g),
         ctypes.c_int(f.dtype == torch.bfloat16), stream_of(f))
    count_launch(hcz_collide_fused, f.dtype == torch.bfloat16)
    return f_out, g_out


hcz_collide_fused.launches = 0
hcz_collide_fused.launches_bf16 = 0
