"""B3: the capillogue, capillary stage + HCZ collide + next-step emission.

Replaces the TPU kernel ``lbm_ferrofluid_tpu/ops/pallas/capillogue.py:
lbm_capillogue`` (:809).  The TPU kernel collides f and g in place, which is
safe there only because its z-ring reads lead its writes; its emission
streams collided neighbours held in that ring.  GPU blocks run in any order
with no grid-wide barrier, so the CUDA source ``csrc/capillogue.cu`` runs a
chain of ``N_LAUNCHES`` = 4 launches and collides out of place into a new
f/g pair:

  (a) fai, prho, chi and the Laplacian of density(rho_ca), into scratch;
  (b) gradients, force, velocity/pressure recovery, re-stream and collide
      (dfai and dprho stay in registers): blocks walk z over 32 x 8 tiles
      with the stencil fields in a 3-plane shared-memory ring, and the
      collide keeps per-cell scalars only, two blocks an SM;
  (c) the prologue kernel on f'/g' with rho_old = rho_ca and vel_old = the
      recovered velocity (the next step's rho, vel, density, m0g, m1g);
  (d) the next step's pre-scaled Poisson source from the emitted density.

The steady state emits no force (the reference overwrites it unread each
step, LBM_collision_HCZ_3d.py:225).  The plain version is the composition
``hcz_capillary`` -> ``hcz_collide`` -> ``stream_bounce_macro/moments`` ->
``poisson_rhs_scaled``.

f and g may be stored in bfloat16 (the JAX package's turbo mode): launches
(b) and (c) then run their kernels' bfloat16 instances, (b) rounding f'/g'
once on the store and (c) reading those stored values, as the TPU
kernel's emission re-streams f'/g' through the storage dtype.

Bound on an H100: bytes, 382 B per cell plus 20 B per fluid and 12 B per
other cell (see :func:`cost`): 2.01 ms at 256^3 over 3.35 TB/s; 230 B per
cell plus the same, 1.23 ms, in bfloat16 storage.
"""

from __future__ import annotations

import ctypes

import torch

from ...lattice import D3Q19
from ...utils.types import CellType
from ..collide import MU0, hcz_capillary, hcz_collide
from ..magnetic import poisson_rhs_scaled
from ..moments import phi_from_density
from ..stream import bounce_back, stream
from ._lib import (STORAGE, call, check_cuda, check_no_grad, count_launch, elem_bytes, ptr,
                   stream_of)
from .fused_step import cost as prologue_cost
from .fused_step import lbm_prologue_plain, stream_macro_launch

__all__ = ["lbm_capillogue", "lbm_capillogue_plain", "cost", "N_LAUNCHES"]

TPU_KERNEL = "lbm_ferrofluid_tpu/ops/pallas/capillogue.py:809"
CUDA_SOURCE = "lbm_ferrofluid_tpu_torch/csrc/capillogue.cu"
N_LAUNCHES = 4


def cost(f, g, flags, rho_pre, density_pre, pressure_old, rho_ca, H2, g_sum, g_mom,
         vel_old, magnetic_flags, **_) -> tuple[int, int]:
    """(bytes, flops) that a call on these inputs must move and do.

    Bytes: f, g (in their storage type), both flag fields, rho_pre,
    density_pre, pressure_old and
    rho_ca read at every cell (the stencils reach every cell); H2, g_sum
    and g_mom only at fluid cells (the force and the recovery are used
    nowhere else) and vel_old only at the others; f', g' and 15 float
    channels written.  Flops: (a) ~110 per cell (EOS, chi, 19-point
    Laplacian of the density map), (b) ~1000 per fluid cell (4 x 3
    gradient components, force and recovery, 19 x 2 equilibrium/forcing
    updates; other cells keep their bounced values), (c) the prologue's
    count on the emitted fields, (d) ~52 per magnetic fluid cell (chi at
    three cells and the staggered difference)."""
    n = flags.numel()
    fluid = int(CellType.FLUID)
    n_fluid = int((flags == fluid).sum())
    n_mfluid = int((magnetic_flags == fluid).sum())
    fg = 19 * (elem_bytes(f) + elem_bytes(g))
    nbytes = n * (2 * fg + 2 + 4 * 4 + 15 * 4) + 20 * n_fluid + 12 * (n - n_fluid)
    emit_flops = prologue_cost(f, g, flags, rho_ca, vel_old)[1]
    return nbytes, 110 * n + 1000 * n_fluid + emit_flops + 52 * n_mfluid


def lbm_capillogue_plain(f, g, flags, rho_pre, density_pre, pressure_old, rho_ca,
                         H2, g_sum, g_mom, vel_old, magnetic_flags, *, kappa, gravity,
                         rho_gas, rho_fluid, density_gas, density_fluid, tau_f,
                         tau_g, dx=1.0, dt=1.0, emit_rhs):
    """Plain PyTorch version of :func:`lbm_capillogue`."""
    lat = D3Q19
    axis, hm, tau_mag = emit_rhs
    f_post = bounce_back(lat, stream(lat, f), flags)
    g_post = bounce_back(lat, stream(lat, g), flags)
    grav = torch.tensor(gravity, dtype=vel_old.dtype, device=vel_old.device)
    rho, vel, den, pres, force, dfai, dprho = hcz_capillary(
        rho_pre, vel_old, flags, density_pre, pressure_old, rho_ca, H2,
        phi_from_density(density_pre, density_gas, density_fluid), g_sum, g_mom,
        kappa=kappa, gravity=grav.reshape(1, 3, 1, 1, 1), rho_gas=rho_gas,
        rho_fluid=rho_fluid, density_gas=density_gas,
        density_fluid=density_fluid, dx=dx, dt=dt,
    )
    f_n, g_n = hcz_collide(
        lat, f_post, g_post, rho, vel, den, pres, flags, force, dfai, dprho,
        tau_f=tau_f, tau_g=tau_g, dx=dx, dt=dt,
    )
    mac = lbm_prologue_plain(
        f_n, g_n, flags, rho, vel, c=dx / dt, rho_gas=rho_gas, rho_fluid=rho_fluid,
        density_gas=density_gas, density_fluid=density_fluid,
    )
    h_ext = tuple(float(hm) if d == axis else 0.0 for d in range(3))
    rhs = poisson_rhs_scaled(
        phi_from_density(mac[2], density_gas, density_fluid), magnetic_flags, h_ext,
        tau=tau_mag, dx=dx, dt=dt,
    )
    return f_n, g_n, vel, pres, den, mac + (rhs,)


def lbm_capillogue(f, g, flags, rho_pre, density_pre, pressure_old, rho_ca, H2,
                   g_sum, g_mom, vel_old, magnetic_flags, *, kappa, gravity,
                   rho_gas, rho_fluid, density_gas, density_fluid, tau_f, tau_g,
                   dx=1.0, dt=1.0, emit_rhs):
    """One steady-state pass: capillary stage, HCZ collide, next-step emission.

    ``rho_pre``/``density_pre``/``g_sum``/``g_mom``/``vel_old`` come from
    the carried premac, ``pressure_old`` from the state, ``rho_ca`` from the
    contact-angle kernel, ``H2`` from the Poisson solve; ``gravity`` is a
    3-tuple and ``emit_rhs = (axis, magnitude, tau)`` the static external
    field along x (0) or y (1).  Returns
    ``(f', g', vel, pressure, density(rho_ca), premac)`` with premac the
    6-tuple (rho, vel, density, m0g, m1g, rhs_scaled) of the next step.
    CPU tensors take the plain version; CUDA tensors launch the kernels;
    anything else raises.  Inputs are not modified.
    """
    kw = dict(kappa=kappa, gravity=gravity, rho_gas=rho_gas, rho_fluid=rho_fluid,
              density_gas=density_gas, density_fluid=density_fluid, tau_f=tau_f,
              tau_g=tau_g, dx=dx, dt=dt, emit_rhs=emit_rhs)
    if f.device.type == "cpu":
        return lbm_capillogue_plain(
            f, g, flags, rho_pre, density_pre, pressure_old, rho_ca, H2, g_sum,
            g_mom, vel_old, magnetic_flags, **kw,
        )
    check_no_grad("lbm_capillogue", f, g, rho_pre, density_pre, pressure_old, rho_ca, H2,
                  g_sum, g_mom, vel_old)
    B, Q, Z, Y, X = f.shape
    scalar = (1, 1, Z, Y, X)
    for name, t in (("rho_pre", rho_pre), ("density_pre", density_pre),
                    ("pressure_old", pressure_old), ("rho_ca", rho_ca), ("H2", H2),
                    ("g_sum", g_sum)):
        check_cuda(name, t, torch.float32, scalar)
    check_cuda("g_mom", g_mom, torch.float32, (1, 3, Z, Y, X))
    check_cuda("magnetic_flags", magnetic_flags, torch.uint8, scalar)
    check_cuda("f", f, STORAGE, (1, 19, Z, Y, X))
    check_cuda("g", g, (f.dtype,), (1, 19, Z, Y, X))
    check_cuda("flags", flags, torch.uint8, scalar)
    check_cuda("vel_old", vel_old, torch.float32, (1, 3, Z, Y, X))
    axis, hm, tau_mag = emit_rhs
    if axis not in (0, 1) or min(Z, Y, X) < 3:
        raise ValueError("lbm_capillogue needs an in-plane field axis and Z, Y, X >= 3")
    dims = (ctypes.c_int(Z), ctypes.c_int(Y), ctypes.c_int(X))
    gas = tuple(ctypes.c_double(float(v))
                for v in (rho_gas, rho_fluid, density_gas, density_fluid))
    st = stream_of(f)

    scratch = torch.empty((4, 1, Z, Y, X), dtype=torch.float32, device=f.device)
    fai, prho, chi, lap = scratch
    call("lbm_cap_derived", ptr(rho_pre), ptr(density_pre), ptr(pressure_old), ptr(rho_ca),
         ptr(fai), ptr(prho), ptr(chi), ptr(lap), *dims, ctypes.c_double(dx),
         ctypes.c_double(dt), *gas, st)
    bf16 = f.dtype == torch.bfloat16
    count_launch(lbm_capillogue, bf16)

    f_out, g_out = torch.empty_like(f), torch.empty_like(g)
    vel, pres, den = torch.empty_like(vel_old), torch.empty_like(rho_ca), torch.empty_like(rho_ca)
    call("lbm_cap_collide", ptr(f), ptr(g), ptr(flags), ptr(rho_ca),
         ptr(H2), ptr(g_sum), ptr(g_mom), ptr(vel_old), ptr(pressure_old), ptr(fai),
         ptr(prho), ptr(chi), ptr(lap), ptr(f_out), ptr(g_out), ptr(vel), ptr(pres),
         ptr(den), *dims, ctypes.c_double(kappa),
         *(ctypes.c_double(float(v)) for v in gravity), ctypes.c_double(0.5 * MU0),
         ctypes.c_double(tau_f), ctypes.c_double(tau_g), ctypes.c_double(dx),
         ctypes.c_double(dt), *gas, ctypes.c_int(bf16), st)
    count_launch(lbm_capillogue, bf16)

    mac = stream_macro_launch(
        f_out, g_out, flags, rho_ca, vel,
        (dx / dt, rho_gas, rho_fluid, density_gas, density_fluid),
    )
    count_launch(lbm_capillogue, bf16)
    rhs = torch.empty_like(rho_ca)
    call("lbm_cap_rhs", ptr(mac[2]), ptr(magnetic_flags), ptr(rhs), *dims,
         ctypes.c_int(axis), ctypes.c_double(hm), ctypes.c_double(tau_mag),
         ctypes.c_double(dx), ctypes.c_double(dt), gas[2], gas[3], st)
    count_launch(lbm_capillogue, bf16)
    return f_out, g_out, vel, pres, den, mac + (rhs,)


lbm_capillogue.launches = 0
lbm_capillogue.launches_bf16 = 0
