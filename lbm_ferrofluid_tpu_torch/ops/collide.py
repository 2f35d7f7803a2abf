"""Collision operators: BGK, entropic KBC, Shan-Chen and He-Chen-Zhang.

PyTorch twins of ``lbm_ferrofluid_tpu/ops/collide.py``: ``bgk_collide``
(:51), ``kbc_moment_split`` (:72), ``_entropic_relax`` (:168),
``kbc_collide`` (:212), ``sc_force`` (:234), ``sc_collide`` (:293),
``smooth_phi`` (:315), ``contact_angle_boundary`` in 2D and 3D (:321),
``hcz_capillary`` (:510) and ``hcz_collide`` with KBC on g (:759);
reference LBM_collision_2d.py, LBM_collision_MRT_2d.py,
LBM_collision_SC_2d.py and LBM_collision_HCZ_{2,3}d.py.  Each takes 2D
([B, C, Y, X], D2Q9) and 3D ([B, C, Z, Y, X], D3Q19) fields where the JAX
op does; KBC is D2Q9 only, as in the reference.  They are the plain
versions that ``ops/kernels/contact3d.py`` (B2), ``ops/kernels/capmac.py``
(B6), ``ops/kernels/hcz3d.py`` (B9) and ``ops/kernels/capillogue.py`` (B3)
are held against in 3D; the capillary stage's stencil route
(``ops/kernels/stencil3d.py:hcz_capillary_stencils``) shares its potentials
and macro recovery with ``hcz_capillary``.  The contact angle is its own
stage here (the caller passes ``rho_ca``); the JAX function runs it inside
``hcz_capillary``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..lattice import Lattice, get_lattice
from ..utils.types import CellType, KBCType, widen
from .equilibrium import feq, gamma_quadratic, geq
from .moments import eos_pressure, rho_to_density
from .stencils import isotropic_grad, isotropic_laplacian, rep_pad_interior

__all__ = [
    "MU0",
    "CHI_K",
    "bgk_collide",
    "kbc_moment_split",
    "kbc_collide",
    "sc_force",
    "sc_collide",
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


def _e_comp(lat: Lattice, d: int, like):
    """The lattice's d-th velocity component shaped [1, Q, 1, ...]."""
    return torch.as_tensor(
        lat.e[:, d].reshape(1, lat.q, *([1] * lat.dim)).astype(np.float64),
        dtype=like.dtype, device=like.device,
    )


def bgk_collide(lat: Lattice, f, rho, vel, flags, force, *, tau, dx=1.0, dt=1.0):
    """LBGK relaxation f' = (1 - 1/tau) f + feq/tau, frozen on OBSTACLE
    cells, with the forcing by equilibrium shift of ``feq``
    (LBM_collision_2d.py:258-287)."""
    feq_val = feq(lat, rho, vel, dx=dx, dt=dt, tau=tau, force=force)
    out = (1.0 - 1.0 / tau) * f.to(feq_val.dtype) + feq_val / tau
    return torch.where(flags == int(CellType.OBSTACLE), f, out).to(f.dtype)


def kbc_moment_split(lat: Lattice, f, rho, vel, kbc_type, *, dx=1.0, dt=1.0):
    """Shear part ``s`` [B, 9, Y, X] of the KBC moment decomposition of f
    (LBM_collision_MRT_2d.py:62-182): KBC A/B take central moments (e - u),
    C/D raw moments; A/C keep the normal-stress difference N in s; a
    non-KBC id also folds Qxxy, Qxyy and A into s.  The reference's scaling
    quirks are kept: central moments carry one factor c per axis whatever
    their order, raw moments c^(p+q)."""
    if lat.q != 9:
        raise ValueError("KBC moment split is defined for D2Q9 only")
    c = dx / dt
    fr = f / rho
    ex, ey = _e_comp(lat, 0, f), _e_comp(lat, 1, f)
    if KBCType.is_KBC_AB(kbc_type):
        bx = ex - vel[:, 0:1]
        by = ey - vel[:, 1:2]
        c2 = c * c
        m20 = c2 * torch.sum(bx * bx * fr, dim=1)
        m02 = c2 * torch.sum(by * by * fr, dim=1)
        m11 = c2 * torch.sum(bx * by * fr, dim=1)
        m21 = c2 * torch.sum(bx * bx * by * fr, dim=1)
        m12 = c2 * torch.sum(bx * by * by * fr, dim=1)
        m22 = c2 * torch.sum(bx * bx * by * by * fr, dim=1)
    else:
        m20 = (c * c) * torch.sum(ex * ex * fr, dim=1)
        m02 = (c * c) * torch.sum(ey * ey * fr, dim=1)
        m11 = (c * c) * torch.sum(ex * ey * fr, dim=1)
        m21 = (c * c * c) * torch.sum(ex * ex * ey * fr, dim=1)
        m12 = (c * c * c) * torch.sum(ex * ey * ey * fr, dim=1)
        m22 = (c * c * c * c) * torch.sum(ex * ex * ey * ey * fr, dim=1)
    T = m20 + m02
    N = m20 - m02
    PI = m11
    r = rho[:, 0]
    s = [r * (1.0 - T)] + [0.25 * r * T] * 4 + [
        0.25 * r * PI, -0.25 * r * PI, 0.25 * r * PI, -0.25 * r * PI]
    if KBCType.is_KBC_AC(kbc_type):
        s[1] = s[1] + 0.25 * r * N
        s[3] = s[3] + 0.25 * r * N
        s[2] = s[2] - 0.25 * r * N
        s[4] = s[4] - 0.25 * r * N
    if not KBCType.is_KBC(kbc_type):
        A, Qxxy, Qxyy = m22, m21, m12
        ux, uy = vel[:, 0], vel[:, 1]
        s[0] = s[0] + r * A
        s[1] = s[1] + 0.5 * r * ((ux - Qxyy) - A)
        s[3] = s[3] + 0.5 * r * (-(ux - Qxyy) - A)
        s[2] = s[2] + 0.5 * r * ((uy - Qxxy) - A)
        s[4] = s[4] + 0.5 * r * (-(uy - Qxxy) - A)
        s[5] = s[5] + 0.25 * r * (A + Qxyy + Qxxy)
        s[6] = s[6] + 0.25 * r * (A - Qxyy + Qxxy)
        s[7] = s[7] + 0.25 * r * (A - Qxyy - Qxxy)
        s[8] = s[8] + 0.25 * r * (A + Qxyy - Qxxy)
    return torch.stack(s, dim=1)


def _entropic_relax(lat: Lattice, f, feq_val, rho, vel, kbc_type, tau, *, dx, dt):
    """The entropic stabilizer's update f + beta (-2 ds - gamma dh)
    (LBM_collision_MRT_2d.py:184-226), with the JAX package's guard: where
    the estimator's denominator is at noise level (den <= 1e-10 |Σ feq|,
    0/0 where f == feq, which makes the reference's demo_2d_wave NaN at
    step 0) gamma is 2, which is LBGK; elsewhere the reference formula."""
    ds = (kbc_moment_split(lat, f, rho, vel, kbc_type, dx=dx, dt=dt)
          - kbc_moment_split(lat, feq_val, rho, vel, kbc_type, dx=dx, dt=dt))
    dh = (f - feq_val) - ds
    beta = 0.5 / tau
    num = torch.sum(ds * dh / feq_val, dim=1, keepdim=True)
    den = torch.sum(dh * dh / feq_val, dim=1, keepdim=True)
    scale = torch.sum(feq_val, dim=1, keepdim=True)
    ill = den <= 1e-10 * torch.abs(scale)
    one = torch.ones((), dtype=den.dtype, device=den.device)
    gamma = torch.where(
        ill, 2.0, 1.0 / beta - (2.0 - 1.0 / beta) * num / torch.where(ill, one, den))
    return f + beta * (-2.0 * ds - gamma * dh)


def kbc_collide(lat: Lattice, f, rho, vel, flags, force, *, tau, kbc_type, dx=1.0, dt=1.0):
    """Entropic KBC collision, frozen on OBSTACLE cells
    (LBM_collision_MRT_2d.py:184-226)."""
    feq_val = feq(lat, rho, vel, dx=dx, dt=dt, tau=tau, force=force)
    out = _entropic_relax(lat, widen(f), feq_val, rho, vel, kbc_type, tau, dx=dx, dt=dt)
    return torch.where(flags == int(CellType.OBSTACLE), f, out).to(f.dtype)


def sc_force(lat: Lattice, density, flags, *, density_wall, dx=1.0, dt=1.0):
    """Shan-Chen interaction force F = -G1 psi(x) c Σ_q w_q e_q psi(x + e_q),
    with the wall's psi on OBSTACLE cells, zero padding outside the domain
    and zero force off FLUID cells (LBM_collision_SC_2d.py:22-97)."""
    c = dx / dt
    cs2 = c * c / 3.0
    RT, a, b, G1 = cs2, 12.0 * cs2, 4.0, -1.0 / 3.0

    def psi_sq(dens):  # psi^2, for tensors and Python floats alike
        eta = dens * b / 4.0
        p = RT * (1.0 + (4.0 * eta - 2.0 * eta * eta) / (1.0 - eta) ** 3) - a * dens - cs2
        return 2.0 * dens * p / G1 / cs2

    psx = torch.sqrt(psi_sq(density))
    psx_wall = math.sqrt(psi_sq(float(density_wall)))
    psx_eff = torch.where(flags == int(CellType.OBSTACLE), psx_wall, psx)
    dim = lat.dim
    psx_pad = torch.nn.functional.pad(psx_eff, (1, 1) * dim)
    comps = []
    for d in range(dim):
        acc = None
        for q in range(1, lat.q):
            off = tuple(int(v) for v in lat.e[q][::-1])
            idx = [slice(None)] * (psx_pad.ndim - dim) + [
                slice(1 + o, None if o == 1 else -1 + o) for o in off]
            term = float(lat.weights[q] * lat.e[q, d]) * psx_pad[tuple(idx)]
            acc = term if acc is None else acc + term
        comps.append(acc)
    force = -G1 * psx * c * torch.cat(comps, dim=1)
    return torch.where(flags == int(CellType.FLUID), force, torch.zeros_like(force))


def sc_collide(lat: Lattice, f, rho, density, vel, flags, *, tau, density_wall, dx=1.0,
               dt=1.0):
    """Shan-Chen collision: the interaction force, then BGK with the
    velocity-shift forcing.  Returns (f', force)."""
    force = sc_force(lat, density, flags, density_wall=density_wall, dx=dx, dt=dt)
    return bgk_collide(lat, f, rho, vel, flags, force, tau=tau, dx=dx, dt=dt), force



def smooth_phi(phi, eps: float):
    """Smeared Heaviside of the order parameter (reference: HCZ_2d.py:175-179)."""
    ramp = 0.5 + (0.5 / eps) * phi + (0.5 / np.pi) * torch.sin((np.pi / eps) * phi)
    return (phi > eps).to(phi.dtype) * 1.0 + (phi.abs() <= eps).to(phi.dtype) * ramp


def contact_angle_boundary(rho, flags, contact_angle: float):
    """Rewrite the boundary ring of rho to impose the wetting contact angle.

    The reference's sequential in-place surgery, each group reading the
    already-updated field.  2D (HCZ_2d.py:83-121): x faces, y faces, then
    the four corners one after another, the last averaging rho[-2, -2]
    with itself as the reference does.  3D (HCZ_3d.py:84-211): x faces, y
    faces (reading the updated x borders), z faces (plain interior copies),
    the 12 edge lines, then the 8 corners.  Returns a new tensor; ``rho``
    is not modified.
    """
    t = math.tan(math.pi / 2.0 - contact_angle)
    OBS = int(CellType.OBSTACLE)
    eps = 1e-6
    rho = rho.clone()
    E = Ellipsis
    if rho.ndim == 4:
        I = slice(1, -1)  # noqa: E741
        for col, src, nb in ((0, 2, 1), (-1, -3, -2)):  # x faces
            hlp = torch.abs(rho[E, 2:, nb] - rho[E, :-2, nb])
            rho[E, I, col] = torch.where(flags[E, I, col] == OBS,
                                         rho[E, I, src] + t * hlp, rho[E, I, col])
        for row, src, nb in ((0, 2, 1), (-1, -3, -2)):  # y faces
            hlp = torch.abs(rho[E, nb, 2:] - rho[E, nb, :-2])
            rho[E, row, I] = torch.where(flags[E, row, I] == OBS,
                                         rho[E, src, I] + t * hlp, rho[E, row, I])
        rho[E, 0, 0] = 0.5 * (rho[E, 1, 0] + rho[E, 0, 1])
        rho[E, -1, 0] = 0.5 * (rho[E, -2, 0] + rho[E, -1, 1])
        rho[E, 0, -1] = 0.5 * (rho[E, 0, -2] + rho[E, 1, -1])
        rho[E, -1, -1] = 0.5 * (rho[E, -2, -2] + rho[E, -2, -2])
        return rho

    def _face_hlp(a, b, c_, d):
        return torch.sqrt(eps + (a - b) ** 2 + (c_ - d) ** 2)

    def _set(idx, new):
        rho[idx] = torch.where(flags[idx] == OBS, new, rho[idx])

    I = slice(1, -1)  # noqa: E741
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
        lat = get_lattice(g.ndim - 2)
        e = torch.as_tensor(lat.e.T.astype(np.float64), dtype=g.dtype, device=g.device)
        g_mom = torch.cat(
            [torch.sum(g * e[d].reshape(1, -1, *([1] * lat.dim)), dim=1, keepdim=True)
             for d in range(lat.dim)], dim=1,
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
    potentials and macro recovery from g (HCZ_2d.py:21-173,
    HCZ_3d.py:21-263), in 2D or 3D by the fields' rank.

    ``rho``/``density``/``pressure`` are this step's pre-contact-angle
    macros (fai and prho are taken from them) and ``rho_ca`` the
    contact-angle-rewritten rho, which the caller computes (B2) where the
    JAX function rewrites it itself.  ``H2``/``phi`` give the Kelvin force;
    with both None there is no Kelvin term and no chi.
    ``g_sum``/``g_mom`` are the streamed Σ_q g_q and Σ_q g_q e_q, taken
    from the post-stream ``g`` when None.  ``gravity`` is a
    ``[1, dim, 1, ...]`` tensor.  Returns (rho_ca, vel, density(rho_ca),
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
    *, tau_f, tau_g, kbc_type=None, dx=1.0, dt=1.0,
):
    """HCZ two-distribution collision with Guo-style forcing on the
    post-stream f and g; updates apply on FLUID cells only
    (HCZ_2d.py:282-284, HCZ_3d.py:213-263).  With a KBC ``kbc_type`` (D2Q9
    only, as in the reference) g relaxes through the entropic stabilizer
    instead of LBGK (HCZ_2d.py:244-256).  bfloat16 f and g are widened
    to float32, collided, and rounded once to their storage dtype on
    return, as the JAX op's ``astype(f.dtype)``."""
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

    if KBCType.is_KBC(kbc_type):
        collision_g = _entropic_relax(lat, g, geq_val, rho, vel, kbc_type, tau_g, dx=dx,
                                      dt=dt)
    else:
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
