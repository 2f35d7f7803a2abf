"""Ferrofluid solver: HCZ multiphase + tau == 1 magnetic Poisson solve +
Kelvin force, on one device.

Port of the steady state of ``lbm_ferrofluid_tpu/models/ferrofluid.py:
ferrofluid_step_impl`` (:406-580).  After :func:`prime_premac` each step is

1. this step's streamed macros and Poisson source from ``state.premac``;
2. the scalar Poisson solve with in-kernel H2 (B1,
   ``ops/kernels/scalar_poisson.py``);
3. the contact-angle rewrite of rho (B2, ``ops/kernels/contact3d.py``);
4. the capillogue: capillary stage, HCZ collide of f and g, and the next
   step's macros and source (B3, ``ops/kernels/capillogue.py``).

Priming runs the prologue (B4, ``ops/kernels/fused_step.py``).  Every entry
point runs on the card unless ``device="cpu"`` is passed, and the kernels
run unless ``plain=True`` is passed, which selects their plain PyTorch
versions.  Configurations outside this slice raise ``NotImplementedError``
naming their ROADMAP item; nothing falls back.
"""

from __future__ import annotations

import torch

from ..ops.equilibrium import feq, geq
from ..ops.kernels.capillogue import lbm_capillogue, lbm_capillogue_plain
from ..ops.kernels.contact3d import contact_angle_3d, contact_angle_3d_plain
from ..ops.kernels.fused_step import lbm_prologue, lbm_prologue_plain
from ..ops.magnetic import poisson_rhs_scaled, solve_H_int_scalar
from ..ops.moments import eos_pressure, phi_from_density
from ..ops.scalar_poisson import make_cmask, s_prev_from_h, scalar_from_h
from ..ops.stencils import staggered
from ..utils.device import check_device, resolve_device
from ..utils.types import CellType
from .multiphase import check_supported, storage_dtype
from .params import SimulationParams
from .state import FerrofluidState

__all__ = [
    "init_ferrofluid_state", "ferrofluid_step", "make_H_ext", "prime_premac",
    "phi_field",
]


def phi_field(params: SimulationParams, state):
    """The order parameter phi = -(2 (density - rho_g)/(rho_l - rho_g) - 1)
    (demo_3d_LBM_Rosensweig_instability.py:171), derived from the current
    density when the carried steady state does not store it."""
    if state.phi is not None:
        return state.phi
    return phi_from_density(state.density, params.density_gas, params.density_fluid)


def make_H_ext(params: SimulationParams, res, batch=1, dtype=torch.float32,
               device=None):
    """Constant external field of magnitude mag_strength along
    params.h_ext_axis, plus its MAC staggering."""
    H = torch.zeros((batch, params.dim, *res), dtype=dtype,
                    device=resolve_device(device))
    H[:, params.h_ext_axis] = params.mag_strength
    return H, tuple(staggered(H))


def validate_mag_shell(params: SimulationParams, magnetic_flags) -> None:
    """Check the ``mag_flags_shell`` declaration against the flags: the
    magnetic obstacles must lie in the x-edge columns and z-edge planes."""
    if not (params.mag_flags_shell and params.dim == 3):
        return
    if (magnetic_flags[..., 1:-1, :, 1:-1] == int(CellType.OBSTACLE)).any():
        raise ValueError(
            "params.mag_flags_shell=True, but magnetic_flags has OBSTACLE "
            "cells outside the x-edge columns / z-edge planes shell; unset "
            "mag_flags_shell for this geometry"
        )


def init_ferrofluid_state(params: SimulationParams, rho, density, vel, flags,
                          magnetic_flags, *, device=None):
    """Initial state from numpy arrays or tensors: f = feq, g = geq at the
    given macros, h = 0.  Runs on the card unless ``device="cpu"``."""
    dev = resolve_device(device)
    lat = params.lattice
    rho = torch.as_tensor(rho, device=dev)
    density = torch.as_tensor(density, device=dev)
    vel = torch.as_tensor(vel, device=dev)
    flags = torch.as_tensor(flags, device=dev)
    magnetic_flags = torch.as_tensor(magnetic_flags, device=dev)
    pressure = eos_pressure(density, dx=params.dx, dt=params.dt)
    f = feq(lat, density, vel, dx=params.dx, dt=params.dt)
    g = geq(lat, rho, density, pressure, f, dx=params.dx, dt=params.dt)
    fg_dt = storage_dtype(params.fg_dtype)
    f, g = f.to(fg_dt), g.to(fg_dt)
    h = torch.zeros(f.shape, dtype=storage_dtype(params.h_dtype), device=dev)
    validate_mag_shell(params, magnetic_flags)
    H_ext, H_ext_mac = make_H_ext(
        params, tuple(rho.shape[2:]), batch=rho.shape[0], dtype=rho.dtype, device=dev,
    )
    return FerrofluidState(
        f=f, g=g, h=h, rho=rho, vel=vel, density=density, pressure=pressure,
        force=torch.zeros_like(vel), phi=torch.zeros_like(rho), flags=flags,
        magnetic_flags=magnetic_flags, H_ext=H_ext, H_ext_mac=H_ext_mac, step=0,
    )


def _mag_boundary_only(magnetic_flags) -> bool:
    """Every magnetic OBSTACLE cell lies on the domain's outermost ring:
    the physics precondition of the tau == 1 scalar collapse."""
    interior = magnetic_flags[..., 1:-1, 1:-1, 1:-1]
    return not bool((interior == int(CellType.OBSTACLE)).any())


def _scalar_physics_ok(params: SimulationParams, magnetic_flags) -> bool:
    """Preconditions of the tau == 1 scalar Poisson collapse (the JAX
    package's ``_scalar_physics_ok``)."""
    return (
        params.scalar_carry
        and float(params.tau) == 1.0
        and (params.mag_flags_shell or _mag_boundary_only(magnetic_flags))
    )


def _check_supported(params: SimulationParams, state) -> None:
    """Raise for configurations this slice does not cover."""
    check_supported(params, state.f)
    if params.h_ext_axis not in (0, 1):
        raise NotImplementedError(
            f"h_ext_axis={params.h_ext_axis}: only an in-plane field (x or y) is "
            "ported.  The JAX step runs an out-of-plane field through the "
            "capillogue with the Poisson source recomputed each step, and only "
            "the padded transposed layout uses it (scenes.rosensweig_3d_tpu, "
            "ROADMAP A8)"
        )
    if state.h.shape[1] != 2 and not _scalar_physics_ok(params, state.magnetic_flags):
        raise NotImplementedError(
            "the magnetic solve needs the tau == 1 scalar collapse (tau == 1, "
            "scalar_carry, magnetic obstacles on the boundary ring only); the "
            "channel-form solve is not ported yet (ROADMAP B7/B11)"
        )


def _hext_static(params: SimulationParams):
    return tuple(
        float(params.mag_strength) if d == params.h_ext_axis else 0.0
        for d in range(3)
    )


def _scalar_convert(state):
    """(h2, cmask) of the scalar carry from a canonical channel h (zeros at
    init, post-collision h of any tau == 1 run)."""
    if state.h.shape[1] == 2:
        return state.h, state.cmask
    s = scalar_from_h(state.h, state.magnetic_flags)
    sp = s_prev_from_h(state.h, state.magnetic_flags)
    return torch.cat([s, sp], dim=1), make_cmask(state.magnetic_flags)


def prime_premac(params: SimulationParams, state: FerrofluidState, *,
                 device=None, plain=False) -> FerrofluidState:
    """Run the prologue once and carry this step's macros and Poisson source
    in ``state.premac`` (a 6-tuple); convert h to the scalar carry; drop the
    write-only phi, force and H_ext (``_prime_steady`` of the JAX package).
    A state that is already primed is returned as it is."""
    check_device(state.f, device)
    _check_supported(params, state)
    if state.premac is not None:
        # checked when it was primed; the flags check reads the device
        # and would stall every step's enqueue
        return state
    validate_mag_shell(params, state.magnetic_flags)
    prologue = lbm_prologue_plain if plain else lbm_prologue
    premac = prologue(
        state.f, state.g, state.flags, state.rho, state.vel,
        c=params.dx / params.dt, rho_gas=params.rho_gas,
        rho_fluid=params.rho_fluid, density_gas=params.density_gas,
        density_fluid=params.density_fluid,
    )
    rhs = poisson_rhs_scaled(
        phi_from_density(premac[2], params.density_gas, params.density_fluid),
        state.magnetic_flags, _hext_static(params), tau=params.tau,
        dx=params.dx, dt=params.dt,
    )
    h, cmask = _scalar_convert(state)
    return state.replace(
        h=h, cmask=cmask, premac=tuple(premac) + (rhs,), phi=None, force=None,
        H_ext=None,
    )


def ferrofluid_step(params: SimulationParams, state: FerrofluidState, *,
                    device=None, plain=False) -> FerrofluidState:
    """One outer step of the steady state; primes an unprimed state first.

    ``plain=True`` runs the kernels' plain PyTorch versions (on any device)
    instead of the kernels."""
    state = prime_premac(params, state, device=device, plain=plain)
    rho, vel, density, m0g, m1g, rhs = state.premac
    H2, h = solve_H_int_scalar(
        state.h, state.cmask, rhs, n_iters=params.poisson_iters, dx=params.dx,
        h2_ext=_hext_static(params), plain=plain,
    )
    surgery = contact_angle_3d_plain if plain else contact_angle_3d
    rho_ca = surgery(rho, state.flags, float(params.contact_angle))
    capillogue = lbm_capillogue_plain if plain else lbm_capillogue
    f, g, vel, pressure, density, premac = capillogue(
        state.f, state.g, state.flags, rho, density, state.pressure, rho_ca, H2,
        m0g, m1g, vel, state.magnetic_flags,
        kappa=float(params.kappa),
        gravity=tuple(float(v) for v in params.gravity_vec().reshape(-1)),
        rho_gas=float(params.rho_gas), rho_fluid=float(params.rho_fluid),
        density_gas=float(params.density_gas),
        density_fluid=float(params.density_fluid),
        tau_f=float(params.tau_f), tau_g=float(params.tau_g),
        dx=float(params.dx), dt=float(params.dt),
        emit_rhs=(params.h_ext_axis, float(params.mag_strength), float(params.tau)),
    )
    return state.replace(
        f=f, g=g, h=h, rho=rho_ca, vel=vel, density=density, pressure=pressure,
        step=state.step + 1, premac=premac,
    )
