"""Equilibrium distributions: feq (exact exponential form), geq, Gamma, and
the magnetic Poisson equilibrium heq.

PyTorch twins of ``lbm_ferrofluid_tpu/ops/equilibrium.py`` (reference:
LBM_collision_2d.py:113-191, LBM_collision_3d.py:133-187):

    feq_q = rho * w_q * prod_d (2 - sqrt(1 + 3 u_d^2/c^2))
                      * prod_d ((2 u_d/c + sqrt(1+3u_d^2/c^2)) / (1 - u_d/c)) ^ e_{q,d}

with the integer power unrolled into a select between ``x``, ``1/x`` and 1.
Weights are cast to the field dtype, so float32 fields use float32-rounded
weights exactly as the JAX ops do.
"""

from __future__ import annotations

import numpy as np
import torch

from ..lattice import Lattice

__all__ = ["feq", "geq", "gamma_quadratic", "heq"]


def _weights(lat: Lattice, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(lat.w_bcast(np.float64), dtype=like.dtype,
                           device=like.device)


def feq(lat: Lattice, rho, vel, *, dx=1.0, dt=1.0, tau=None, force=None):
    """Exponential-form equilibrium ``[B, Q, *res]`` from rho ``[B, 1, *res]``
    and vel ``[B, dim, *res]``.  With ``force`` the velocity is first shifted
    by ``tau * force / rho`` (the reference's forcing by equilibrium shift,
    LBM_collision_2d.py:121-123)."""
    if force is not None:
        if tau is None:
            raise ValueError("feq: force shift requires tau")
        vel = vel + tau * force / rho
    c = dx / dt
    u = vel / c
    t = torch.sqrt(1.0 + 3.0 * u * u)
    plus = (2.0 * u + t) / (1.0 - u)
    minus = 1.0 / plus

    out = rho * _weights(lat, rho)
    for d in range(lat.dim):
        out = out * (2.0 - t[:, d:d + 1])
    ones = torch.ones_like(rho)
    for d in range(lat.dim):
        pd, md = plus[:, d:d + 1], minus[:, d:d + 1]
        fac = torch.cat(
            [pd if e == 1 else (md if e == -1 else ones) for e in lat.e[:, d]],
            dim=1,
        )
        out = out * fac
    return out


def geq(lat: Lattice, rho, density, pressure, feq_val=None, *, vel=None, dx=1.0,
        dt=1.0, tau=None, force=None):
    """geq = w*(p - cs2*density) + cs2*density/rho * feq
    (reference: LBM_collision_2d.py:163-181).  Without ``feq_val``, feq is
    evaluated from ``vel`` (with the ``tau``/``force`` shift of :func:`feq`)."""
    c = dx / dt
    cs2 = c * c / 3.0
    if feq_val is None:
        feq_val = feq(lat, rho, vel, dx=dx, dt=dt, tau=tau, force=force)
    w = _weights(lat, rho)
    return w * (pressure - cs2 * density) + cs2 * density / rho * feq_val


def gamma_quadratic(lat: Lattice, vel, *, dx=1.0, dt=1.0):
    """Γ_q = w_q (1 + e·u/cs2 + (e·u)^2/(2 cs2^2) - u·u/(2 cs2))
    (reference: LBM_collision_HCZ_2d.py:181-191)."""
    c = dx / dt
    cs2 = c * c / 3.0
    w = _weights(lat, vel)
    uv = torch.sum(vel * vel, dim=1, keepdim=True)
    eu = torch.zeros_like(w * uv)
    for d in range(lat.dim):
        ed = torch.as_tensor(
            lat.e[:, d].reshape(1, lat.q, *([1] * lat.dim)).astype(np.float64),
            dtype=vel.dtype, device=vel.device,
        )
        eu = eu + vel[:, d:d + 1] * ed * c
    return w * (1.0 + eu / cs2 + 0.5 * eu * eu / (cs2 * cs2) - 0.5 * uv / cs2)


def heq(lat: Lattice, psi):
    """Equilibrium of the magnetic-potential Poisson distribution h:
    w_q * psi for q > 0 and (w_0 - 1) * psi for the rest population (Chai
    et al. 2007 eq. 2.2; reference: LBM_magnetic_2d.py:88-97)."""
    w = np.copy(lat.weights)
    w[0] -= 1.0
    return psi * torch.as_tensor(w.reshape(1, lat.q, *([1] * lat.dim)), dtype=psi.dtype,
                                 device=psi.device)
