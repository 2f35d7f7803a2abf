"""He-Chen-Zhang multiphase solver (two distributions f, g), 3D, one device.

Port of ``lbm_ferrofluid_tpu/models/multiphase.py``: ``init_hcz_state``
(:108) and the HCZ step ``_hcz_step_shared`` (:175-256) without ``jit`` or
``mesh``.  A step is

1. stream + bounce of f with rho, vel (frozen at obstacles) and density
   (B8b, ``ops/kernels/stream3d.py:stream_bounce_macro``);
2. stream + bounce of g with its raw moments (B8a, ``stream_bounce_moments``);
3. velocity pinning, if the state carries a mask;
4. the contact-angle rewrite of rho (B2, ``ops/kernels/contact3d.py``);
5. the capillary stage: force, dfai, dprho and the velocity and pressure
   recovery (B6, ``ops/kernels/capmac.py``), then pinning again;
6. the HCZ LBGK collide of f and g (B9, ``ops/kernels/hcz3d.py``).

The JAX step takes B6 only where gravity is a concrete value; inside its
``jit`` gravity is traced, so on the TPU it runs the stencil kernels (B10)
instead.  The port has no ``jit`` and its gravity is always a tuple of
floats, so it runs the branch that ``hcz_capillary`` itself picks for a
concrete gravity.  Every entry point runs on the card unless
``device="cpu"``; ``plain=True`` runs the kernels' plain PyTorch versions.
The Shan-Chen step and the 2D forms are ROADMAP A7.
"""

from __future__ import annotations

import torch

from ..ops.equilibrium import feq, geq
from ..ops.kernels import KERNELS
from ..ops.kernels.capmac import hcz_capillary_gradmac, hcz_capillary_gradmac_plain
from ..ops.kernels.contact3d import contact_angle_3d, contact_angle_3d_plain
from ..ops.kernels.hcz3d import hcz_collide_fused, hcz_collide_fused_plain
from ..ops.kernels.stream3d import (
    stream_bounce_macro,
    stream_bounce_macro_plain,
    stream_bounce_moments,
    stream_bounce_moments_plain,
)
from ..ops.moments import eos_pressure, rho_to_density
from ..utils.device import check_device, resolve_device
from ..utils.types import KBCType
from .params import SimulationParams
from .state import HCZState

__all__ = ["init_hcz_state", "hcz_step"]


def storage_dtype(name: str) -> torch.dtype:
    """The torch dtype of a ``params.fg_dtype``/``h_dtype`` name.  float64
    runs the plain versions only (on the CPU or with ``plain=True``): the
    kernels take float32 and raise on anything else."""
    if name not in ("float32", "float64"):
        raise NotImplementedError(
            f"storage dtype {name!r}: only float32 and float64 f/g/h storage is "
            "ported (bfloat16 storage is ROADMAP A6)"
        )
    return getattr(torch, name)


def check_supported(params: SimulationParams, f: torch.Tensor) -> None:
    """Raise for what the 3D HCZ family (HCZ and ferrofluid) does not cover
    yet, naming the ROADMAP item."""
    if params.dim != 3:
        raise NotImplementedError("2D models are not ported yet (ROADMAP A7)")
    if params.kbc_type is not None and KBCType.is_KBC(params.kbc_type):
        raise NotImplementedError("KBC collisions are not ported yet (ROADMAP A7)")
    storage_dtype(params.fg_dtype)
    storage_dtype(params.h_dtype)
    if params.phys_extent is not None:
        raise NotImplementedError(
            "padded transposed layouts (phys_extent) are not ported yet (ROADMAP A8)"
        )
    if params.gravity_axis not in (0, 1, 2):
        raise ValueError(f"gravity_axis={params.gravity_axis} is not an axis")
    if f.shape[0] != 1:
        raise NotImplementedError(
            "batched states are not ported yet (data-parallel dispatch, ROADMAP A12)"
        )


def check_kernel_grid(f: torch.Tensor, plain: bool) -> None:
    """Raise on the card without ``plain=True`` where the grid has an axis
    shorter than a kernel wrapper's ``min_axis`` (B2's needs 4, and every
    step runs B2), before any kernel launches.  The plain versions (the
    CPU, or ``plain=True``) step any grid the JAX step steps (the JAX
    package gates only its kernels and steps smaller grids through jnp)."""
    if plain or f.device.type != "cuda":
        return
    grid = tuple(f.shape[2:])
    short = [f"{kid} {k.wrapper.__name__} (>= {k.wrapper.min_axis})"
             for kid, k in KERNELS.items() if min(grid) < getattr(k.wrapper, "min_axis", 1)]
    if short:
        raise ValueError(f"grid {grid}: the kernels {', '.join(short)} need more cells an "
                         "axis; pass plain=True to step this grid on the plain versions")


def init_hcz_state(params: SimulationParams, rho, density, vel, flags,
                   vel_pin_mask=None, vel_pin_value=None, *, device=None) -> HCZState:
    """Initial state from numpy arrays or tensors: f = feq at the physical
    density (the reference's init idiom, demo_2d_LBM_multiphase_HCZ.py:114),
    g = geq.  Runs on the card unless ``device="cpu"``."""
    dev = resolve_device(device)
    lat = params.lattice
    rho = torch.as_tensor(rho, device=dev)
    density = torch.as_tensor(density, device=dev)
    vel = torch.as_tensor(vel, device=dev)
    force = torch.zeros_like(vel)
    pressure = eos_pressure(density, dx=params.dx, dt=params.dt)
    f = feq(lat, density, vel, dx=params.dx, dt=params.dt, tau=params.tau, force=force)
    g = geq(lat, rho, density, pressure, f, dx=params.dx, dt=params.dt)
    fg_dt = storage_dtype(params.fg_dtype)

    def optional(x):
        return None if x is None else torch.as_tensor(x, device=dev)

    return HCZState(
        f=f.to(fg_dt), g=g.to(fg_dt), rho=rho, vel=vel, density=density,
        pressure=pressure, force=force, flags=torch.as_tensor(flags, device=dev), step=0,
        vel_pin_mask=optional(vel_pin_mask), vel_pin_value=optional(vel_pin_value),
    )


def _maybe_pin(state: HCZState, vel):
    if state.vel_pin_mask is not None:
        return torch.where(state.vel_pin_mask, state.vel_pin_value, vel)
    return vel


def hcz_step(params: SimulationParams, state: HCZState, *, device=None,
             plain=False) -> HCZState:
    """One HCZ step.  ``plain=True`` runs the kernels' plain PyTorch
    versions (on any device) instead of the kernels."""
    check_device(state.f, device)
    check_supported(params, state.f)
    check_kernel_grid(state.f, plain)
    dx, dt = float(params.dx), float(params.dt)
    gas = dict(rho_gas=float(params.rho_gas), rho_fluid=float(params.rho_fluid),
               density_gas=float(params.density_gas),
               density_fluid=float(params.density_fluid))
    macro = stream_bounce_macro_plain if plain else stream_bounce_macro
    moments = stream_bounce_moments_plain if plain else stream_bounce_moments
    surgery = contact_angle_3d_plain if plain else contact_angle_3d
    capillary = hcz_capillary_gradmac_plain if plain else hcz_capillary_gradmac
    collide = hcz_collide_fused_plain if plain else hcz_collide_fused

    f, rho, vel, density = macro(state.f, state.flags, state.rho, state.vel, c=dx / dt,
                                 **gas)
    g, m0g, m1g = moments(state.g, state.flags)
    vel = _maybe_pin(state, vel)
    rho_ca = surgery(rho, state.flags, float(params.contact_angle))
    vel, pressure, force, dfai, dprho = capillary(
        rho, density, state.pressure, rho_ca, None, None, state.flags, m0g, m1g, vel,
        kappa=float(params.kappa),
        gravity=tuple(float(v) for v in params.gravity_vec().reshape(-1)),
        dx=dx, dt=dt, **gas,
    )
    density = rho_to_density(rho_ca, **gas)
    vel = _maybe_pin(state, vel)
    f, g = collide(f, g, rho_ca, vel, density, pressure, state.flags, force, dfai, dprho,
                   tau_f=float(params.tau_f), tau_g=float(params.tau_g), dx=dx, dt=dt)
    return state.replace(f=f, g=g, rho=rho_ca, vel=vel, density=density,
                         pressure=pressure, force=force, step=state.step + 1)
