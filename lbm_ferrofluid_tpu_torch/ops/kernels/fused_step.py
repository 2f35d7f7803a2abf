"""B4: the prologue, stream + bounce of f and g straight to the macro fields.

Replaces the TPU kernel ``lbm_ferrofluid_tpu/ops/pallas/fused_step.py:
lbm_prologue`` (:721).  The CUDA source is ``csrc/fused_step.cu``, whose
entry point the capillogue's emission launches too: one thread per cell
pulls 19 + 19 values with periodic wrap on every axis, bounces them at
obstacles and writes rho (frozen at obstacles), vel, density, m0g and m1g.
A call is one launch.  The plain version is
``ops/stream.py:stream_bounce_macro`` + ``stream_bounce_moments``.

Bound on an H100: bytes, 189 B per cell plus 16 B per obstacle cell (read
f, g and flags everywhere, rho_old and vel_old at obstacles; write 9
channels): 0.948 ms at 256^3 over 3.35 TB/s.
"""

from __future__ import annotations

import ctypes

import torch

from ...lattice import D3Q19
from ...utils.types import CellType
from ..stream import stream_bounce_macro, stream_bounce_moments
from ._lib import call, check_cuda, ptr, stream_of

__all__ = ["lbm_prologue", "lbm_prologue_plain", "cost", "stream_macro_launch"]

TPU_KERNEL = "lbm_ferrofluid_tpu/ops/pallas/fused_step.py:721"
CUDA_SOURCE = "lbm_ferrofluid_tpu_torch/csrc/fused_step.cu"


def cost(f, g, flags, rho_old, vel_old, **_) -> tuple[int, int]:
    """(bytes, flops) that a call on these inputs must move and do: f, g
    and flags read at every cell, rho_old and vel_old only at obstacles, 9
    float channels written; m0g/m1g (48 flops) and the density map (3) at
    every cell, m0f/m1f (48) and vel (1 divide, 3 multiplies) elsewhere."""
    n = flags.numel()
    n_obs = int((flags == int(CellType.OBSTACLE)).sum())
    return n * (2 * 76 + 1 + 36) + 16 * n_obs, n * 51 + (n - n_obs) * 52


def lbm_prologue_plain(f, g, flags, rho_old, vel_old, *, c, rho_gas, rho_fluid,
                       density_gas, density_fluid):
    """Plain PyTorch version of :func:`lbm_prologue`."""
    _, rho, vel, density = stream_bounce_macro(
        D3Q19, f, flags, rho_old, vel_old, c=c, rho_gas=rho_gas,
        rho_fluid=rho_fluid, density_gas=density_gas, density_fluid=density_fluid,
    )
    _, m0g, m1g = stream_bounce_moments(D3Q19, g, flags)
    return rho, vel, density, m0g, m1g


def stream_macro_launch(f, g, flags, rho_old, vel_old, consts):
    """Check shapes, allocate the 5 outputs and launch the stream-macro
    kernel; shared with the capillogue's emission, which counts its own
    launches."""
    B, Q, Z, Y, X = f.shape
    check_cuda("f", f, torch.float32, (1, 19, Z, Y, X))
    check_cuda("g", g, torch.float32, (1, 19, Z, Y, X))
    check_cuda("flags", flags, torch.uint8, (1, 1, Z, Y, X))
    check_cuda("rho_old", rho_old, torch.float32, (1, 1, Z, Y, X))
    check_cuda("vel_old", vel_old, torch.float32, (1, 3, Z, Y, X))
    rho = torch.empty_like(rho_old)
    vel = torch.empty_like(vel_old)
    den = torch.empty_like(rho_old)
    m0g = torch.empty_like(rho_old)
    m1g = torch.empty_like(vel_old)
    call("lbm_prologue", ptr(f), ptr(g), ptr(flags), ptr(rho_old), ptr(vel_old), ptr(rho),
         ptr(vel), ptr(den), ptr(m0g), ptr(m1g), ctypes.c_int(Z), ctypes.c_int(Y),
         ctypes.c_int(X), *(ctypes.c_double(float(v)) for v in consts), stream_of(f))
    return rho, vel, den, m0g, m1g


def lbm_prologue(f, g, flags, rho_old, vel_old, *, c, rho_gas, rho_fluid,
                 density_gas, density_fluid):
    """f, g [1, 19, Z, Y, X] float32, flags uint8, rho_old [1, 1, ...],
    vel_old [1, 3, ...] -> (rho, vel, density, m0g, m1g).  CPU tensors take
    the plain version; CUDA tensors launch the kernel; anything else
    raises."""
    if f.device.type == "cpu":
        return lbm_prologue_plain(
            f, g, flags, rho_old, vel_old, c=c, rho_gas=rho_gas, rho_fluid=rho_fluid,
            density_gas=density_gas, density_fluid=density_fluid,
        )
    out = stream_macro_launch(
        f, g, flags, rho_old, vel_old, (c, rho_gas, rho_fluid, density_gas, density_fluid),
    )
    lbm_prologue.launches += 1
    return out


lbm_prologue.launches = 0
