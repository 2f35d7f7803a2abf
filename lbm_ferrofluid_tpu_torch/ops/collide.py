"""He-Chen-Zhang multiphase collision pieces of the 3D main path.

PyTorch twins of ``lbm_ferrofluid_tpu/ops/collide.py``: ``smooth_phi``
(:315), the 3D ``contact_angle_boundary`` (:321), ``hcz_capillary`` (:510)
and the LBGK ``hcz_collide`` (:759); reference LBM_collision_HCZ_3d.py.
They are the plain versions that ``ops/kernels/contact3d.py`` (B2),
``ops/kernels/capmac.py`` (B6), ``ops/kernels/hcz3d.py`` (B9) and
``ops/kernels/capillogue.py`` (B3) are held against; the capillary stage's
stencil route (``ops/kernels/stencil3d.py:hcz_capillary_stencils``) shares
its potentials and macro recovery with ``hcz_capillary``.  The contact angle is
its own stage here (the caller passes ``rho_ca``); the JAX function runs it
inside ``hcz_capillary``.  The BGK/KBC/Shan-Chen collisions and the 2D forms
are ROADMAP A7.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..lattice import D3Q19, Lattice
from ..utils.types import CellType, widen
from .equilibrium import feq, gamma_quadratic, geq
from .moments import eos_pressure, rho_to_density
from .stencils import isotropic_grad, isotropic_laplacian, rep_pad_interior

__all__ = [
    "MU0",
    "CHI_K",
    "smooth_phi",
    "chi_of_phi",
    "contact_angle_boundary",
    "capillary_potentials",
    "recover_macros",
    "hcz_capillary",
    "hcz_collide",
]

MU0 = 4.0 * math.pi * 1e-7  # vacuum permeability (reference: LBM_collision_HCZ_2d.py:142)
CHI_K = 0.33  # susceptibility scale hardcoded in the reference (HCZ_2d.py:143)


def smooth_phi(phi, eps: float):
    """Smeared Heaviside of the order parameter (reference: HCZ_2d.py:175-179)."""
    ramp = 0.5 + (0.5 / eps) * phi + (0.5 / np.pi) * torch.sin((np.pi / eps) * phi)
    return (phi > eps).to(phi.dtype) * 1.0 + (phi.abs() <= eps).to(phi.dtype) * ramp


def contact_angle_boundary(rho, flags, contact_angle: float):
    """Rewrite the boundary ring of rho to impose the wetting contact angle.

    The reference's sequential in-place surgery (HCZ_3d.py:84-211): x faces,
    y faces (reading the updated x borders), z faces (plain interior
    copies), the 12 edge lines, then the 8 corners, each group reading the
    already-updated field.  Returns a new tensor; ``rho`` is not modified.
    """
    t = math.tan(math.pi / 2.0 - contact_angle)
    OBS = int(CellType.OBSTACLE)
    eps = 1e-6
    rho = rho.clone()

    def _face_hlp(a, b, c_, d):
        return torch.sqrt(eps + (a - b) ** 2 + (c_ - d) ** 2)

    def _set(idx, new):
        rho[idx] = torch.where(flags[idx] == OBS, new, rho[idx])

    I = slice(1, -1)  # noqa: E741
    E = Ellipsis
    # 1./2. x faces
    _set((E, I, I, 0), rho[E, I, I, 2] + t * _face_hlp(
        rho[E, 2:, I, 1], rho[E, :-2, I, 1], rho[E, I, 2:, 1], rho[E, I, :-2, 1]))
    _set((E, I, I, -1), rho[E, I, I, -3] + t * _face_hlp(
        rho[E, 2:, I, -2], rho[E, :-2, I, -2], rho[E, I, 2:, -2], rho[E, I, :-2, -2]))
    # 3./4. y faces
    _set((E, I, 0, I), rho[E, I, 2, I] + t * _face_hlp(
        rho[E, 2:, 1, I], rho[E, :-2, 1, I], rho[E, I, 1, 2:], rho[E, I, 1, :-2]))
    _set((E, I, -1, I), rho[E, I, -3, I] + t * _face_hlp(
        rho[E, 2:, -2, I], rho[E, :-2, -2, I], rho[E, I, -2, 2:], rho[E, I, -2, :-2]))
    # 5./6. z faces: plain interior copies (the reference computes hlp but
    # does not apply it, HCZ_3d.py:143-168)
    _set((E, 0, I, I), rho[E, 2, I, I])
    _set((E, -1, I, I), rho[E, -3, I, I])
    # 7. edge lines (12), in the reference's order (HCZ_3d.py:170-184)
    rho[E, I, 0, 0] = 0.5 * (rho[E, I, 0, 1] + rho[E, I, 1, 0])
    rho[E, I, 0, -1] = 0.5 * (rho[E, I, 0, -2] + rho[E, I, 1, -1])
    rho[E, I, -1, 0] = 0.5 * (rho[E, I, -1, 1] + rho[E, I, -2, 0])
    rho[E, I, -1, -1] = 0.5 * (rho[E, I, -1, -2] + rho[E, I, -2, -1])
    rho[E, 0, I, 0] = 0.5 * (rho[E, 0, I, 1] + rho[E, 1, I, 0])
    rho[E, 0, I, -1] = 0.5 * (rho[E, 0, I, -2] + rho[E, 1, I, -1])
    rho[E, -1, I, 0] = 0.5 * (rho[E, -1, I, 1] + rho[E, -2, I, 0])
    rho[E, -1, I, -1] = 0.5 * (rho[E, -1, I, -2] + rho[E, -2, I, -1])
    rho[E, 0, 0, I] = 0.5 * (rho[E, 0, 1, I] + rho[E, 1, 0, I])
    rho[E, 0, -1, I] = 0.5 * (rho[E, 0, -2, I] + rho[E, 1, -1, I])
    rho[E, -1, 0, I] = 0.5 * (rho[E, -1, 1, I] + rho[E, -2, 0, I])
    rho[E, -1, -1, I] = 0.5 * (rho[E, -1, -2, I] + rho[E, -2, -1, I])
    # 8. corners (HCZ_3d.py:186-211)
    for z, zn in ((0, 1), (-1, -2)):
        for y, yn in ((0, 1), (-1, -2)):
            for x, xn in ((0, 1), (-1, -2)):
                rho[E, z, y, x] = (
                    rho[E, z, y, xn] + rho[E, z, yn, x] + rho[E, zn, y, x]
                ) / 3.0
    return rho


def chi_of_phi(phi, dx):
    """Magnetic susceptibility chi = CHI_K (1 - smooth_phi(phi, 0.1 dx))
    (HCZ_2d.py:143)."""
    return CHI_K * (1.0 - smooth_phi(phi, 0.1 * dx))


def capillary_potentials(rho, density, pressure, *, dx=1.0, dt=1.0):
    """The EOS potentials fai = p_eos(rho) - rho RT and prho = p - RT
    density, each with its boundary ring replaced by the nearest interior
    value (HCZ_3d.py:21-60); taken from the pre-contact-angle fields."""
    c = dx / dt
    RT = c * c / 3.0
    fai = rep_pad_interior(eos_pressure(rho, dx=dx, dt=dt) - rho * RT)
    return fai, rep_pad_interior(pressure - RT * density)


def recover_macros(flags, vel, pressure, density, force, dprho, g_sum, g_mom, g, *, dx=1.0,
                   dt=1.0):
    """Velocity and pressure recovered from the moments of g at FLUID cells
    (the old values elsewhere); ``g_sum``/``g_mom`` are taken from the
    post-stream ``g`` when None.  Returns (vel, pressure)."""
    c = dx / dt
    RT = c * c / 3.0
    if g is not None:
        g = widen(g)
    if g_mom is None:
        e = torch.as_tensor(D3Q19.e.T.astype(np.float64), dtype=g.dtype, device=g.device)
        g_mom = torch.cat(
            [torch.sum(g * e[d].reshape(1, -1, 1, 1, 1), dim=1, keepdim=True)
             for d in range(3)], dim=1,
        )
    if g_sum is None:
        g_sum = torch.sum(g, dim=1, keepdim=True)
    macro_vel = (g_mom * c + 0.5 * dt * RT * force) / RT / density
    is_fluid = flags == int(CellType.FLUID)
    vel = torch.where(is_fluid, macro_vel, vel)
    macro_pressure = g_sum - 0.5 * dt * torch.sum(vel * dprho, dim=1, keepdim=True)
    return vel, torch.where(is_fluid, macro_pressure, pressure)


def hcz_capillary(
    rho, vel, flags, density, pressure, rho_ca, H2=None, phi=None, g_sum=None,
    g_mom=None, *, g=None, kappa, gravity, rho_gas, rho_fluid, density_gas,
    density_fluid, dx=1.0, dt=1.0,
):
    """HCZ capillary step: surface-tension/gravity/Kelvin forces, EOS
    potentials and macro recovery from g (HCZ_3d.py:21-263).

    ``rho``/``density``/``pressure`` are this step's pre-contact-angle
    macros (fai and prho are taken from them) and ``rho_ca`` the
    contact-angle-rewritten rho, which the caller computes (B2) where the
    JAX function rewrites it itself.  ``H2``/``phi`` give the Kelvin force;
    with both None there is no Kelvin term and no chi.
    ``g_sum``/``g_mom`` are the streamed Σ_q g_q and Σ_q g_q e_q, taken
    from the post-stream ``g`` when None.  ``gravity`` is a
    ``[1, 3, 1, 1, 1]`` tensor.  Returns (rho_ca, vel, density(rho_ca),
    pressure, force, dfai, dprho).
    """
    if (H2 is None) != (phi is None):
        raise ValueError("hcz_capillary: give H2 and phi together, or neither")
    fai, prho = capillary_potentials(rho, density, pressure, dx=dx, dt=dt)
    density = rho_to_density(
        rho_ca, rho_gas=rho_gas, rho_fluid=rho_fluid,
        density_gas=density_gas, density_fluid=density_fluid,
    )
    lap_density = isotropic_laplacian(density, dx)
    force = kappa * density * isotropic_grad(lap_density, dx, flags)
    force = force + gravity * density
    if H2 is not None:
        force = force - 0.5 * MU0 * H2 * isotropic_grad(chi_of_phi(phi, dx), dx, flags)
    dfai = isotropic_grad(fai, dx, flags)
    dprho = isotropic_grad(prho, dx, flags)
    vel, pressure = recover_macros(flags, vel, pressure, density, force, dprho, g_sum, g_mom,
                                   g, dx=dx, dt=dt)
    return rho_ca, vel, density, pressure, force, dfai, dprho


def hcz_collide(
    lat: Lattice, f, g, rho, vel, density, pressure, flags, force, dfai, dprho,
    *, tau_f, tau_g, dx=1.0, dt=1.0,
):
    """HCZ two-distribution LBGK collision with Guo-style forcing on the
    post-stream f and g; updates apply on FLUID cells only
    (HCZ_2d.py:282-284, HCZ_3d.py:213-263).  bfloat16 f and g are widened
    to float32, collided, and rounded once to their storage dtype on
    return, as the JAX op's ``astype(f.dtype)``.  The KBC-stabilized g
    update is ROADMAP A7."""
    f_dtype, g_dtype = f.dtype, g.dtype
    f, g = widen(f), widen(g)
    c = dx / dt
    RT = c * c / 3.0
    feq_val = feq(lat, rho, vel, dx=dx, dt=dt)
    geq_val = geq(lat, rho, density, pressure, feq_val, dx=dx, dt=dt)
    Gamma = gamma_quadratic(lat, vel, dx=dx, dt=dt)
    w = torch.as_tensor(lat.w_bcast(np.float64), dtype=f.dtype, device=f.device)

    def rel_dot(vec):
        # forcing inner product Σ_d (e_qd c - u_d) v_d
        acc = None
        for d in range(lat.dim):
            ed = torch.as_tensor(
                lat.e[:, d].reshape(1, lat.q, *([1] * lat.dim)).astype(np.float64),
                dtype=f.dtype, device=f.device,
            )
            term = (ed * c - vel[:, d:d + 1]) * vec[:, d:d + 1]
            acc = term if acc is None else acc + term
        return acc

    collision_g = g + (geq_val - g) / tau_g
    collision_f = (
        f
        + (feq_val - f) / tau_f
        + dt * (1.0 - 0.5 / tau_f) * Gamma / RT * rel_dot(-dfai) * dt
    )
    collision_g = collision_g + (
        (1.0 - 0.5 / tau_g)
        * (Gamma * rel_dot(force) + (Gamma - w) * rel_dot(-dprho))
        * dt
    )
    is_fluid = flags == int(CellType.FLUID)
    return (torch.where(is_fluid, collision_f, f).to(f_dtype),
            torch.where(is_fluid, collision_g, g).to(g_dtype))
