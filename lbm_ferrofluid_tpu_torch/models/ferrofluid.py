"""Ferrofluid solver: HCZ multiphase + magnetic Poisson solve + Kelvin force,
on one device.

Port of ``lbm_ferrofluid_tpu/models/ferrofluid.py:ferrofluid_step_impl``
(:280-766) on one device.  The step steps the state it is given and never
primes; ``state.premac`` selects one of three routes:

* **6 leaves, the capillogue steady state** (after :func:`prime_premac`,
  which runs the prologue B4 once): this step's macros and Poisson source
  from ``premac``; the magnetic solve; the contact-angle rewrite of rho (B2,
  ``ops/kernels/contact3d.py``); the capillogue, i.e. capillary stage, HCZ
  collide of f and g and the next step's macros and source at the magnetic
  tau (B3, ``ops/kernels/capillogue.py``).  Returns a 6-leaf premac with
  ``phi``, ``force`` and ``H_ext`` None.
* **5 leaves, the epilogue steady state** (a state the JAX package primed
  where its capillogue does not fit, handed over with ``from_numpy``): the
  macros from ``premac``; phi from the density and the Poisson source from
  phi; the solve; B2; the capillary stage with H2 and phi (B6,
  ``ops/kernels/capmac.py``); the epilogue with the next step's macros
  (B5 with ``emit_mac``, ``ops/kernels/fused_step.py``).  Returns a 5-leaf
  premac with ``phi`` and ``force`` as tensors.
* **None, the un-carried step**: the prologue (B4) on ``f``/``g``, then as
  the 5-leaf route with B5 without ``emit_mac``.  Returns ``premac`` None,
  with ``phi``, ``force`` and ``H_ext`` kept.

The magnetic solve runs in the form ``state.h`` has (``h.shape[1]``):
2 channels, the tau == 1 scalar collapse with in-kernel H2 (B1,
``ops/kernels/scalar_poisson.py``), into which :func:`prime_premac` converts
h when ``_scalar_physics_ok`` holds; 19 channels, the Chai Poisson-LBM on
the channel distribution at any tau (``ops/magnetic.py:solve_H_int``: the
sweeps B11b, ``ops/kernels/poisson.py``, then the gradient of psi B10a,
``ops/kernels/stencil3d.py``), as ``init_ferrofluid_state`` makes h.

In 2D (D2Q9) the step is the JAX step's unfused branch on plain PyTorch
on any device, as the JAX package runs 2D only through ``jnp``: stream and
macros of f and g, phi and the Poisson source, the solve in the form
``state.h`` has (9 channels, or the scalar carry with the exact-order
sweeps, into which :func:`prime_premac` converts h and which is its only
2D priming), then the shared 2D HCZ stages with H2 and phi
(``models/multiphase.py:capillary_collide_2d``, KBC on g with
``params.kbc_type``).  A 2D step launches no kernel and carries no premac.

Every entry point runs on the card unless ``device="cpu"`` is passed, and
the kernels run unless ``plain=True`` is passed, which selects their plain
PyTorch versions.  bfloat16 storage of f, g and h (``fg_dtype``/``h_dtype``,
the JAX package's turbo mode) runs on every route, on the kernels'
bfloat16 forms on the card; the scalar carry stays float32.  float64
storage runs on the plain versions only.
Configurations outside the port raise ``NotImplementedError`` naming their
ROADMAP item; nothing falls back.
"""

from __future__ import annotations

import torch

from ..ops.equilibrium import feq, geq
from ..ops.kernels.capillogue import lbm_capillogue, lbm_capillogue_plain
from ..ops.kernels.capmac import hcz_capillary_gradmac, hcz_capillary_gradmac_plain
from ..ops.kernels.contact3d import contact_angle_3d, contact_angle_3d_plain
from ..ops.kernels.fused_step import (
    lbm_epilogue,
    lbm_epilogue_plain,
    lbm_prologue,
    lbm_prologue_plain,
)
from ..ops.magnetic import poisson_rhs_scaled, solve_H_int, solve_H_int_scalar
from ..ops.moments import eos_pressure, phi_from_density, rho_to_density
from ..ops.scalar_poisson import make_cmask, s_prev_from_h, scalar_from_h
from ..ops.stencils import staggered
from ..utils.device import check_device, resolve_device
from ..utils.types import CellType
from .multiphase import (
    capillary_collide_2d,
    check_kernel_grid,
    check_supported,
    storage_dtype,
    stream_2d,
)
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
    interior = magnetic_flags[(Ellipsis,) + (slice(1, -1),) * (magnetic_flags.ndim - 2)]
    return not bool((interior == int(CellType.OBSTACLE)).any())


def _scalar_physics_ok(params: SimulationParams, magnetic_flags) -> bool:
    """Preconditions of the tau == 1 scalar Poisson collapse (the JAX
    package's ``_scalar_physics_ok``): tau == 1, ``scalar_carry``, h not
    stored in float64 (the carry is float32), an axis-aligned field, and
    magnetic obstacles on the boundary ring only."""
    return (
        params.scalar_carry
        and float(params.tau) == 1.0
        and params.h_dtype != "float64"
        and params.h_ext_axis in range(params.dim)
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


def _hext_static(params: SimulationParams):
    return tuple(
        float(params.mag_strength) if d == params.h_ext_axis else 0.0
        for d in range(params.dim)
    )


def _scalar_convert(params: SimulationParams, state):
    """(h, cmask) that the step carries: the scalar pair (s, s_prev) and its
    cmask from a canonical channel h (zeros at init, post-collision h of any
    tau == 1 run) when the collapse applies, else the channel h as it is
    (JAX ``_prime_steady`` :926-929).  The carry is float32 whatever
    ``h_dtype`` stores the channel h in (JAX ``_scalar_convert`` :889-891)."""
    if state.h.shape[1] == 2 or not _scalar_physics_ok(params, state.magnetic_flags):
        return state.h, state.cmask
    s = scalar_from_h(state.h, state.magnetic_flags)
    sp = s_prev_from_h(state.h, state.magnetic_flags)
    return torch.cat([s, sp], dim=1).to(torch.float32), make_cmask(state.magnetic_flags)


def prime_premac(params: SimulationParams, state: FerrofluidState, *,
                 device=None, plain=False) -> FerrofluidState:
    """Run the prologue once and carry this step's macros and Poisson source
    in ``state.premac`` (a 6-tuple); convert h to the scalar carry where the
    collapse applies (else keep the 19-channel h); drop the write-only phi,
    force and H_ext (``_prime_steady`` of the JAX package).
    A state that is already primed is returned as it is.  In 2D the scalar
    carry is the only priming (JAX :969-977): h converts where the
    collapse applies and nothing else changes."""
    check_device(state.f, device)
    _check_supported(params, state)
    if state.premac is not None:
        # checked when it was primed; the flags check reads the device
        # and would stall every step's enqueue
        return state
    if params.dim == 2:
        h, cmask = _scalar_convert(params, state)
        return state.replace(h=h, cmask=cmask)
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
    h, cmask = _scalar_convert(params, state)
    return state.replace(
        h=h, cmask=cmask, premac=tuple(premac) + (rhs,), phi=None, force=None,
        H_ext=None,
    )


def ferrofluid_step(params: SimulationParams, state: FerrofluidState, *,
                    device=None, plain=False) -> FerrofluidState:
    """One outer step of the state as it is given; it never primes.

    ``state.premac`` selects the route, as in the JAX step on one device
    (``ferrofluid_step_impl`` :328-344, :393-395, :516, :679-702): 6 leaves,
    the capillogue steady state; 5 leaves, the epilogue steady state; None,
    the un-carried step.  ``plain=True`` runs the kernels' plain PyTorch
    versions (on any device) instead of the kernels."""
    check_device(state.f, device)
    _check_supported(params, state)
    if params.dim == 2:
        return _ferrofluid_step_2d(params, state)
    check_kernel_grid(state.f, plain)
    gas = dict(rho_gas=float(params.rho_gas), rho_fluid=float(params.rho_fluid),
               density_gas=float(params.density_gas),
               density_fluid=float(params.density_fluid))
    dx, dt = float(params.dx), float(params.dt)
    if state.premac is None:
        prologue = lbm_prologue_plain if plain else lbm_prologue
        rho, vel, density, m0g, m1g = prologue(state.f, state.g, state.flags, state.rho,
                                               state.vel, c=dx / dt, **gas)
    else:
        rho, vel, density, m0g, m1g = state.premac[:5]
    capillogue_route = state.premac is not None and len(state.premac) == 6
    if capillogue_route:
        rhs = state.premac[5]
    else:
        phi = phi_from_density(density, params.density_gas, params.density_fluid)
        rhs = poisson_rhs_scaled(phi, state.magnetic_flags, _hext_static(params),
                                 tau=params.tau, dx=dx, dt=dt)
    H2, h = _solve(params, state, rhs, plain)
    surgery = contact_angle_3d_plain if plain else contact_angle_3d
    rho_ca = surgery(rho, state.flags, float(params.contact_angle))
    grav = tuple(float(v) for v in params.gravity_vec().reshape(-1))
    hcz = dict(tau_f=float(params.tau_f), tau_g=float(params.tau_g), dx=dx, dt=dt)
    if capillogue_route:
        capillogue = lbm_capillogue_plain if plain else lbm_capillogue
        f, g, vel, pressure, density, premac = capillogue(
            state.f, state.g, state.flags, rho, density, state.pressure, rho_ca, H2,
            m0g, m1g, vel, state.magnetic_flags, kappa=float(params.kappa), gravity=grav,
            emit_rhs=(params.h_ext_axis, float(params.mag_strength), float(params.tau)),
            **gas, **hcz,
        )
        return state.replace(
            f=f, g=g, h=h, rho=rho_ca, vel=vel, density=density, pressure=pressure,
            step=state.step + 1, premac=premac,
        )
    # the 5-leaf and the un-carried routes: B2 + B6 with H2 and phi, then
    # the epilogue (models/multiphase.py's composition)
    capillary = hcz_capillary_gradmac_plain if plain else hcz_capillary_gradmac
    vel, pressure, force, dfai, dprho = capillary(
        rho, density, state.pressure, rho_ca, H2, phi, state.flags, m0g, m1g, vel,
        kappa=float(params.kappa), gravity=grav, dx=dx, dt=dt, **gas,
    )
    density = rho_to_density(rho_ca, **gas)
    epilogue = lbm_epilogue_plain if plain else lbm_epilogue
    emit = state.premac is not None
    out = epilogue(state.f, state.g, state.flags, rho_ca, vel, density, pressure, force, dfai,
                   dprho, emit_mac=emit, mac_consts=(dx / dt, *gas.values()), **hcz)
    return state.replace(
        f=out[0], g=out[1], h=h, rho=rho_ca, vel=vel, density=density, pressure=pressure,
        force=force, phi=phi, step=state.step + 1, premac=tuple(out[2]) if emit else None,
    )


def _ferrofluid_step_2d(params: SimulationParams, state):
    """One 2D step: the JAX step's unfused branch (:358-371), the solve by
    the form of ``state.h`` (:394-507) and the shared HCZ stages with H2
    and phi (:636-766)."""
    f, rho, vel, density, g, m0g, m1g = stream_2d(params, state)
    phi = phi_from_density(density, params.density_gas, params.density_fluid)
    hext = _hext_static(params)
    dx, dt = float(params.dx), float(params.dt)
    if state.h.shape[1] == 2:
        rhs = poisson_rhs_scaled(phi, state.magnetic_flags, hext, tau=float(params.tau),
                                 dx=dx, dt=dt)
        H2, h = solve_H_int_scalar(state.h, state.cmask, rhs, n_iters=params.poisson_iters,
                                   dx=dx, h2_ext=hext, magnetic_flags=state.magnetic_flags)
    else:
        H2, h = solve_H_int(params.lattice, state.h, phi, state.magnetic_flags,
                            state.H_ext_mac, tau=float(params.tau),
                            n_iters=params.poisson_iters, dx=dx, dt=dt, h2_ext=hext)
    f, g, rho, vel, density, pressure, force = capillary_collide_2d(
        params, state, f, g, rho, vel, density, m0g, m1g, H2, phi)
    return state.replace(f=f, g=g, h=h, rho=rho, vel=vel, density=density,
                         pressure=pressure, force=force, phi=phi, step=state.step + 1)


def _solve(params: SimulationParams, state, rhs, plain):
    """(H2, h') of the magnetic solve in the form that ``state.h`` has."""
    if state.h.shape[1] == 2:
        return solve_H_int_scalar(
            state.h, state.cmask, rhs, n_iters=params.poisson_iters, dx=params.dx,
            h2_ext=_hext_static(params), plain=plain,
        )
    return solve_H_int(
        params.lattice, state.h, None, state.magnetic_flags, None, tau=float(params.tau),
        n_iters=params.poisson_iters, dx=params.dx, dt=params.dt, rhs_scaled=rhs,
        h2_ext=_hext_static(params), plain=plain,
    )
