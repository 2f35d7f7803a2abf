"""Magnetic source term, Kelvin magnitude and the tau == 1 scalar solve.

PyTorch twins of ``lbm_ferrofluid_tpu/ops/magnetic.py``:
``_stag_diff_times`` (:36), ``poisson_rhs_scaled`` (:64), ``_maybe_h2``
(:104) and the scalar branch of ``solve_H_int_scalar`` (:167).  The Chai
(2007) Poisson-LBM solve (reference LBM_magnetic_3d.py:108-188) collapses at
tau == 1 to the scalar sweeps of ``ops/scalar_poisson.py``; the channel-form
solve for tau != 1 is ROADMAP B7/B11.
"""

from __future__ import annotations

import torch

from ..utils.types import CellType
from .collide import CHI_K, smooth_phi

__all__ = ["poisson_rhs_scaled", "solve_H_int_scalar"]


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


def poisson_rhs_scaled(phi, magnetic_flags, h2_ext, *, tau, dx, dt):
    """The loop-invariant, pre-scaled Poisson source term for a static,
    axis-aligned external field ``h2_ext`` (channel order x, y, z):

    rhs = div(chi H_ext)|_staggered * dx / (1 + chi), zeroed off-fluid,
    times the dt * cs2 (0.5 - tau) dt collision prefactor
    (LBM_magnetic_2d.py:140-155)."""
    c = dx / dt
    cs2 = c * c / 3.0
    chi = CHI_K * (1.0 - smooth_phi(phi, 0.1 * dx))
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
    """H2 = |h2_ext + H_int|^2 with channel-ascending summation."""
    acc = None
    for d, c in enumerate(h2_ext):
        tot = H_int[:, d:d + 1]
        if c:
            tot = tot + c
        sq = tot * tot
        acc = sq if acc is None else acc + sq
    return acc


def solve_H_int_scalar(s2, cmask, rhs_scaled, *, n_iters=30, dx=1.0, h2_ext,
                       plain=False):
    """Scalar-collapse magnetic solve at tau == 1; returns (H2, s2').

    ``s2`` is the fused [1, 2, Z, Y, X] (s, s_prev) carry and ``cmask`` the
    static obstacle/wall-weight field; its sign marks the magnetic
    obstacles, so the magnetic flags are not needed here.  Runs the
    hand-written kernel (``ops/kernels/scalar_poisson.py``) on CUDA tensors
    and its plain version on CPU tensors or when ``plain`` is set."""
    from .kernels.scalar_poisson import scalar_wavefront, scalar_wavefront_plain

    fn = scalar_wavefront_plain if plain else scalar_wavefront
    s2, H2 = fn(s2, cmask, rhs_scaled, n_iters=n_iters, dx=dx,
                h_ext=tuple(float(v) for v in h2_ext))
    return H2, s2
