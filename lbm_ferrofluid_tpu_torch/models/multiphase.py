"""Multiphase solvers on one device: Shan-Chen (one distribution) and
He-Chen-Zhang (two distributions f, g), in 2D and 3D.

Port of ``lbm_ferrofluid_tpu/models/multiphase.py``: ``init_sc_state`` and
``sc_step`` (:44-106), ``init_hcz_state`` (:108) and the HCZ step
``_hcz_step_shared`` (:175-256) without ``jit`` or ``mesh``.  The Shan-Chen
step (demo_2d_LBM_multiphase_SC.py:114-133) is stream, moments and the
density map, bounce-back, then the Shan-Chen force and BGK; it runs plain
PyTorch, as the JAX step runs ``jnp``.  An HCZ step is

1. stream + bounce of f with rho, vel (frozen at obstacles) and density
   (B8b, ``ops/kernels/stream3d.py:stream_bounce_macro``);
2. stream + bounce of g with its raw moments (B8a, ``stream_bounce_moments``);
3. velocity pinning, if the state carries a mask;
4. the contact-angle rewrite of rho (B2, ``ops/kernels/contact3d.py``);
5. the capillary stage: force, dfai, dprho and the velocity and pressure
   recovery (B6, ``ops/kernels/capmac.py``), then pinning again;
6. the HCZ collide of f and g (B9, ``ops/kernels/hcz3d.py``).

The kernels are the 3D route.  The JAX step takes B6 only where gravity is
a concrete value; inside its ``jit`` gravity is traced, so on the TPU it
runs the stencil kernels (B10) instead.  The port has no ``jit`` and its
gravity is always a tuple of floats, so it runs the branch that
``hcz_capillary`` itself picks for a concrete gravity.  In 2D (D2Q9) the
same six stages run the plain ops on any device, with KBC on g when
``params.kbc_type`` asks for it, as the JAX package runs 2D through
``jnp`` only.  Every entry point runs on the card unless ``device="cpu"``;
``plain=True`` runs the kernels' plain PyTorch versions.  f and g may be
stored in bfloat16 (``fg_dtype``), on the kernels' bfloat16 forms on the
card.
"""

from __future__ import annotations

import torch

from ..ops.collide import contact_angle_boundary, hcz_capillary, hcz_collide, sc_collide
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
from ..ops.moments import eos_pressure, macro_moments, rho_to_density
from ..ops.stream import bounce_back, stream
from ..ops.stream import stream_bounce_macro as stream_bounce_macro_ops
from ..ops.stream import stream_bounce_moments as stream_bounce_moments_ops
from ..utils.device import check_device, resolve_device
from ..utils.types import KBCType
from .params import SimulationParams
from .state import HCZState

__all__ = ["init_sc_state", "sc_step", "init_hcz_state", "hcz_step"]


def storage_dtype(name: str) -> torch.dtype:
    """The torch dtype of a ``params.fg_dtype``/``h_dtype`` name: float32;
    bfloat16, the JAX package's turbo mode (storage only: every op computes
    in float32 and rounds to nearest even where it stores); float64, on
    the plain versions only (on the CPU or with ``plain=True``), since the
    kernels take float32 and bfloat16 and raise on anything else."""
    if name not in ("float32", "bfloat16", "float64"):
        raise NotImplementedError(
            f"storage dtype {name!r}: f/g/h are stored in float32, bfloat16 or "
            "float64, as in the JAX package (which has no float16 mode)"
        )
    return getattr(torch, name)


def check_supported(params: SimulationParams, f: torch.Tensor, hcz: bool = True) -> None:
    """Raise for what the port does not step: a state whose rank or
    distribution count is not ``params.dim``'s lattice, KBC off D2Q9 (the
    JAX package's own ``ValueError``), and (for the HCZ family, ``hcz``)
    the storage dtypes and layouts it has no route for, naming the ROADMAP
    item."""
    lat = params.lattice
    if f.ndim - 2 != params.dim or f.shape[1] != lat.q:
        raise ValueError(
            f"params.dim={params.dim} ({lat.name}) does not match the state: f has shape "
            f"{tuple(f.shape)}"
        )
    if KBCType.is_KBC(params.kbc_type) and lat.q != 9:
        raise ValueError("KBC moment split is defined for D2Q9 only")
    if f.shape[0] != 1:
        raise NotImplementedError(
            "batched states are not ported yet (data-parallel dispatch, ROADMAP A12)"
        )
    if not hcz:
        return
    storage_dtype(params.fg_dtype)
    storage_dtype(params.h_dtype)
    if params.phys_extent is not None:
        raise NotImplementedError(
            "padded transposed layouts (phys_extent) are not ported yet (ROADMAP A8)"
        )
    if params.gravity_axis not in range(params.dim):
        raise ValueError(f"gravity_axis={params.gravity_axis} is not an axis")


def check_kernel_grid(f: torch.Tensor, plain: bool, ids=None) -> None:
    """Raise on the card without ``plain=True`` where the grid has an axis
    shorter than the ``min_axis`` of a kernel wrapper that the step
    launches (``ids``, default all: B2's needs 4, and every HCZ-family step
    runs B2), before any kernel launches.  The plain versions (the CPU,
    ``plain=True``, and every 2D step) step any grid the JAX step steps
    (the JAX package gates only its kernels and steps smaller grids
    through jnp)."""
    if plain or f.device.type != "cuda" or len(f.shape) != 5:
        return
    grid = tuple(f.shape[2:])
    short = [f"{kid} {k.wrapper.__name__} (>= {k.wrapper.min_axis})"
             for kid, k in KERNELS.items()
             if (ids is None or kid in ids) and min(grid) < getattr(k.wrapper, "min_axis", 1)]
    if short:
        raise ValueError(f"grid {grid}: the kernels {', '.join(short)} need more cells an "
                         "axis; pass plain=True to step this grid on the plain versions")


def init_sc_state(params: SimulationParams, rho, density, vel, flags, *,
                  device=None) -> HCZState:
    """Shan-Chen initial state from numpy arrays or tensors: f = feq at the
    physical density (JAX :44-62); ``g`` and ``pressure`` are None.  Runs
    on the card unless ``device="cpu"``."""
    dev = resolve_device(device)
    rho = torch.as_tensor(rho, device=dev)
    density = torch.as_tensor(density, device=dev)
    vel = torch.as_tensor(vel, device=dev)
    force = torch.zeros_like(vel)
    f = feq(params.lattice, density, vel, dx=params.dx, dt=params.dt, tau=params.tau,
            force=force)
    return HCZState(f=f, g=None, rho=rho, vel=vel, density=density, pressure=None,
                    force=force, flags=torch.as_tensor(flags, device=dev), step=0)


def sc_step(params: SimulationParams, state: HCZState, *, device=None,
            plain=False) -> HCZState:
    """One Shan-Chen step (JAX ``sc_step_impl`` :65-106), plain PyTorch on
    any device; ``plain`` is accepted for the runner's and the tests'
    uniform calls and changes nothing."""
    del plain
    check_device(state.f, device)
    check_supported(params, state.f, hcz=False)
    lat = params.lattice
    dx, dt = float(params.dx), float(params.dt)
    f = stream(lat, state.f)
    rho, vel = macro_moments(lat, f, state.rho, state.vel, state.flags, dx=dx, dt=dt)
    density = rho_to_density(rho, rho_gas=params.rho_gas, rho_fluid=params.rho_fluid,
                             density_gas=params.density_gas,
                             density_fluid=params.density_fluid)
    f = bounce_back(lat, f, state.flags)
    f, force = sc_collide(lat, f, rho, density, vel, state.flags, tau=params.tau,
                          density_wall=0.5 * (params.density_gas + params.density_fluid),
                          dx=dx, dt=dt)
    return state.replace(f=f, rho=rho, vel=vel, density=density, force=force,
                         step=state.step + 1)


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


def _maybe_pin(state, vel):
    if getattr(state, "vel_pin_mask", None) is not None:
        return torch.where(state.vel_pin_mask, state.vel_pin_value, vel)
    return vel


def _gas(params: SimulationParams) -> dict:
    return dict(rho_gas=float(params.rho_gas), rho_fluid=float(params.rho_fluid),
                density_gas=float(params.density_gas),
                density_fluid=float(params.density_fluid))


def stream_2d(params: SimulationParams, state):
    """Stages 1-2 in 2D (plain ops): (f', rho, vel, density, g', m0g, m1g)."""
    lat = params.lattice
    f, rho, vel, density = stream_bounce_macro_ops(
        lat, state.f, state.flags, state.rho, state.vel, c=float(params.dx / params.dt),
        **_gas(params))
    g, m0g, m1g = stream_bounce_moments_ops(lat, state.g, state.flags)
    return f, rho, vel, density, g, m0g, m1g


def capillary_collide_2d(params: SimulationParams, state, f, g, rho, vel, density, m0g,
                         m1g, H2=None, phi=None):
    """Stages 4-6 in 2D (plain ops; JAX ``_hcz_step_shared`` :180-256 and the
    ferrofluid step's unfused tail): the contact angle, the capillary stage
    (with the Kelvin force when ``H2`` and ``phi`` are given), pinning and
    the HCZ collide (KBC on g with ``params.kbc_type``).  Returns (f', g',
    rho_ca, vel, density, pressure, force)."""
    dx, dt = float(params.dx), float(params.dt)
    rho_ca = contact_angle_boundary(rho, state.flags, float(params.contact_angle))
    _, vel, density, pressure, force, dfai, dprho = hcz_capillary(
        rho, vel, state.flags, density, state.pressure, rho_ca, H2, phi, m0g, m1g, g=g,
        kappa=float(params.kappa),
        gravity=torch.as_tensor(params.gravity_vec(), dtype=vel.dtype, device=vel.device),
        dx=dx, dt=dt, **_gas(params),
    )
    vel = _maybe_pin(state, vel)
    f, g = hcz_collide(params.lattice, f, g, rho_ca, vel, density, pressure, state.flags,
                       force, dfai, dprho, tau_f=float(params.tau_f),
                       tau_g=float(params.tau_g), kbc_type=params.kbc_type, dx=dx, dt=dt)
    return f, g, rho_ca, vel, density, pressure, force


def hcz_step(params: SimulationParams, state: HCZState, *, device=None,
             plain=False) -> HCZState:
    """One HCZ step.  ``plain=True`` runs the kernels' plain PyTorch
    versions (on any device) instead of the kernels; a 2D step runs the
    plain ops and launches no kernel."""
    check_device(state.f, device)
    check_supported(params, state.f)
    if params.dim == 2:
        f, rho, vel, density, g, m0g, m1g = stream_2d(params, state)
        vel = _maybe_pin(state, vel)
        f, g, rho, vel, density, pressure, force = capillary_collide_2d(
            params, state, f, g, rho, vel, density, m0g, m1g)
        return state.replace(f=f, g=g, rho=rho, vel=vel, density=density,
                             pressure=pressure, force=force, step=state.step + 1)
    check_kernel_grid(state.f, plain)
    dx, dt = float(params.dx), float(params.dt)
    gas = _gas(params)
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
