"""Magnetic scalar-potential solver: an LBM relaxation of the Poisson equation.

PyTorch twins of ``lbm_ferrofluid_tpu/ops/magnetic.py``:
``_stag_diff_times`` (:36), ``poisson_rhs_scaled`` (:64), ``_maybe_h2``
(:104), ``magnetic_sweep`` (:122), the scalar branch of
``solve_H_int_scalar`` (:167) and ``solve_H_int`` (:313).  The Chai (2007)
Poisson-LBM solve (reference LBM_magnetic_3d.py:108-188):

* psi  = Σ_{q>0} h_q / (1 - w_0)
* heq  = psi * w, with the rest population getting (w_0 - 1) psi
* rhs  = div(chi H_ext)|_staggered * dx / (1 + chi), zeroed off-fluid
* h'   = (1 - 1/tau) h + heq/tau + dt * w * rhs * cs2 (0.5 - tau) dt
* H_int = -grad(psi)

runs in two forms: the Q-channel distribution h (:func:`solve_H_int`, any
tau) and, at tau == 1, its scalar collapse (:func:`solve_H_int_scalar`,
``ops/scalar_poisson.py``), each in 3D (D3Q19, with the kernels on the
card) and in 2D (D2Q9, plain PyTorch on any device, as the JAX package runs
2D only through ``jnp``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..lattice import Lattice
from ..utils.types import CellType, widen
from .collide import chi_of_phi
from .equilibrium import heq
from .stencils import (
    isotropic_grad,
    staggered_x,
    staggered_y,
    staggered_z,
    substitute_obstacles,
)
from .scalar_poisson import scalar_sweeps_exact
from .stream import bounce_back, stream

__all__ = [
    "poisson_rhs_scaled", "magnetic_sweep", "solve_H_int", "solve_H_int_scalar", "maybe_h2",
    "h_int_from_psi",
]


def _stag_diff_times(x, axis, hm):
    """``d[j] = stag[j+1]*hm - stag[j]*hm`` of the replicate-staggered ``x``
    along ``axis``; both edge cells' differences are exactly +0.0."""
    n = x.shape[axis]
    idx = torch.arange(n, device=x.device)
    x_p = torch.index_select(x, axis % x.ndim, torch.clamp(idx + 1, max=n - 1))
    x_m = torch.index_select(x, axis % x.ndim, torch.clamp(idx - 1, min=0))
    d = (0.5 * (x + x_p)) * hm - (0.5 * (x_m + x)) * hm
    shape = [1] * x.ndim
    shape[axis] = n
    edge = ((idx == 0) | (idx == n - 1)).reshape(shape)
    return torch.where(edge, torch.zeros((), dtype=x.dtype, device=x.device), d)


def _div_staggered(chi, H_ext_mac):
    """div(chi H_ext) from the MAC-staggered chi times the staggered field
    components (unscaled, every cell; two components in 2D, three in 3D)."""
    chx = staggered_x(chi) * H_ext_mac[0]
    chy = staggered_y(chi) * H_ext_mac[1]
    rhs = (chx[..., 1:] - chx[..., :-1]) + (chy[..., 1:, :] - chy[..., :-1, :])
    if chi.ndim == 4:
        return rhs
    chz = staggered_z(chi) * H_ext_mac[2]
    return rhs + (chz[..., 1:, :, :] - chz[..., :-1, :, :])


def poisson_rhs_scaled(phi, magnetic_flags, h2_ext, *, tau, dx, dt, H_ext_mac=None):
    """The loop-invariant, pre-scaled Poisson source term:

    rhs = div(chi H_ext)|_staggered * dx / (1 + chi), zeroed off-fluid,
    times the dt * cs2 (0.5 - tau) dt collision prefactor
    (LBM_magnetic_2d.py:140-155), in 2D or 3D by ``phi``'s rank.  With
    ``h2_ext`` (the static axis-aligned field, channel order x, y[, z]) the
    staggered difference of the constant
    field is taken directly; with ``h2_ext=None`` from the staggered field
    components ``H_ext_mac``."""
    c = dx / dt
    cs2 = c * c / 3.0
    chi = chi_of_phi(phi, dx)
    if h2_ext is None:
        rhs = _div_staggered(chi, H_ext_mac)
    else:
        rhs = None
        for axis, hm in zip((-1, -2, -3), (float(v) for v in h2_ext)):
            if hm == 0.0:
                continue
            term = _stag_diff_times(chi, axis, hm)
            rhs = term if rhs is None else rhs + term
        if rhs is None:
            rhs = torch.zeros_like(chi)
    rhs = rhs * dx / (1.0 + chi)
    rhs = torch.where(magnetic_flags == int(CellType.FLUID), rhs, torch.zeros_like(rhs))
    return dt * rhs * (cs2 * (0.5 - tau) * dt)


def maybe_h2(H_int, h2_ext):
    """H2 = |h2_ext + H_int|^2 with channel-ascending summation when the
    static field is given, else H_int."""
    if h2_ext is None:
        return H_int
    acc = None
    for d, c in enumerate(h2_ext):
        tot = H_int[:, d:d + 1]
        if c:
            tot = tot + c
        sq = tot * tot
        acc = sq if acc is None else acc + sq
    return acc


def magnetic_sweep(lat: Lattice, h, phi, flags, H_ext_mac, *, tau, dx=1.0, dt=1.0):
    """One Poisson-LBM collision sweep with the source recomputed from
    ``phi`` (not hoisted); returns (H_int, h_new).  ``flags`` is the
    magnetic flag field."""
    c = dx / dt
    cs2 = c * c / 3.0
    h_dtype, h = h.dtype, widen(h)
    w = torch.as_tensor(lat.w_bcast(np.float64), dtype=h.dtype, device=h.device)
    w0 = float(lat.weights[0])
    psi = torch.sum(h[:, 1:], dim=1, keepdim=True) / (1.0 - w0)
    heq_val = heq(lat, psi)
    chi = chi_of_phi(phi, dx)
    rhs = _div_staggered(chi, H_ext_mac) * dx / (1.0 + chi)
    rhs = torch.where(flags == int(CellType.FLUID), rhs, torch.zeros_like(rhs))
    add_h = dt * w * rhs * (cs2 * (0.5 - tau) * dt)
    collision_h = (1.0 - 1.0 / tau) * h + heq_val / tau + add_h
    h_new = torch.where(flags == int(CellType.OBSTACLE), h, collision_h).to(h_dtype)
    return -isotropic_grad(psi, dx, flags), h_new


def h_int_from_psi(psi, magnetic_flags, *, dx, h2_ext, grad=None):
    """The solve's tail: obstacle psi substituted, H_int = -grad(psi_sub)
    through ``grad`` (the B10a kernel or its plain version, 3D), or through
    the plain isotropic gradient of psi's rank when ``grad`` is None (2D and
    the plain bodies), then the static field folded in (JAX
    ``solve_H_int`` :467-478, :500-502)."""
    if grad is None:
        return maybe_h2(-isotropic_grad(psi, dx, magnetic_flags), h2_ext)
    return maybe_h2(-grad(substitute_obstacles(psi, magnetic_flags), dx=dx), h2_ext)


def solve_H_int(lat: Lattice, h, phi, magnetic_flags, H_ext_mac, *, tau, n_iters=30,
                dx=1.0, dt=1.0, rhs_scaled=None, h2_ext=None, plain=False):
    """``n_iters`` sweeps of [stream -> bounce-back -> relaxation] on the
    Q-channel h; returns (H_int of the last sweep's psi, h'), or (H2, h')
    with ``h2_ext``.

    3D CUDA tensors run the hand-written kernels: the sweeps (B11b,
    ``ops/kernels/poisson.py``), then the obstacle substitution of psi and
    the gradient (B10a, ``ops/kernels/stencil3d.py``), as the JAX
    package's psi route (:452-478).  CPU tensors, and ``plain=True`` on any
    device, run the plain body (:480-502).  ``rhs_scaled`` defaults to
    :func:`poisson_rhs_scaled` of ``phi``.

    bfloat16 h is widened to float32 for each sweep and its output rounded
    back, as the JAX body and the TPU kernel store it (psi stays float32).
    The channel weights of the source term are float32 here, as the TPU
    kernel (and B11b) apply them; the JAX body takes them in h's dtype, so
    at bfloat16 its ``add_h`` uses weights rounded to bfloat16 (within
    0.2 %)."""
    if rhs_scaled is None:
        rhs_scaled = poisson_rhs_scaled(phi, magnetic_flags, h2_ext, tau=tau, dx=dx, dt=dt,
                                        H_ext_mac=H_ext_mac)
    if not plain and h.device.type != "cpu" and lat.dim == 3:
        from .kernels.poisson import poisson_sweeps
        from .kernels.stencil3d import grad_fields

        h, psi = poisson_sweeps(h, magnetic_flags, rhs_scaled, tau=tau, n_iters=n_iters)
        return h_int_from_psi(psi, magnetic_flags, dx=dx, h2_ext=h2_ext, grad=grad_fields), h
    h_dtype = h.dtype
    w = torch.as_tensor(lat.w_bcast(np.float64), dtype=widen(h[:, :1]).dtype,
                        device=h.device)
    w0 = float(lat.weights[0])
    add_h = w * rhs_scaled
    is_obs = magnetic_flags == int(CellType.OBSTACLE)
    psi = None
    for _ in range(n_iters):
        hf = widen(bounce_back(lat, stream(lat, h), magnetic_flags))
        psi = torch.sum(hf[:, 1:], dim=1, keepdim=True) / (1.0 - w0)
        collision_h = (1.0 - 1.0 / tau) * hf + heq(lat, psi) / tau + add_h
        h = torch.where(is_obs, hf, collision_h).to(h_dtype)
    return h_int_from_psi(psi, magnetic_flags, dx=dx, h2_ext=h2_ext), h


def solve_H_int_scalar(s2, cmask, rhs_scaled, *, n_iters=30, dx=1.0, h2_ext,
                       magnetic_flags=None, plain=False):
    """Scalar-collapse magnetic solve at tau == 1; returns (H2, s2').

    ``s2`` is the fused [1, 2, *res] (s, s_prev) carry and ``cmask`` the
    static obstacle/wall-weight field.  3D: its sign marks the magnetic
    obstacles, so the magnetic flags are not needed; runs the hand-written
    kernel (``ops/kernels/scalar_poisson.py``) on CUDA tensors and its plain
    version on CPU tensors or when ``plain`` is set.  2D: the exact-order
    sweeps (:func:`ops.scalar_poisson.scalar_sweeps_exact`) and the 2D
    gradient of the last psi on any device, which need ``magnetic_flags``
    (JAX ``solve_H_int_scalar`` :229-257)."""
    if s2.ndim == 4:
        psi, s, sp = scalar_sweeps_exact(s2[:, :1], s2[:, 1:2], rhs_scaled, magnetic_flags,
                                         n_iters)
        return (h_int_from_psi(psi, magnetic_flags, dx=dx, h2_ext=h2_ext),
                torch.cat([s, sp], dim=1))
    from .kernels.scalar_poisson import scalar_wavefront, scalar_wavefront_plain

    fn = scalar_wavefront_plain if plain else scalar_wavefront
    s2, H2 = fn(s2, cmask, rhs_scaled, n_iters=n_iters, dx=dx,
                h_ext=tuple(float(v) for v in h2_ext))
    return H2, s2
