"""Macroscopic moments, order-parameter map and equation of state (PyTorch
twins of ``lbm_ferrofluid_tpu/ops/moments.py``; reference:
LBM_macro_compute_2d.py:51-101)."""

from __future__ import annotations

import numpy as np
import torch

from ..lattice import Lattice
from ..utils.types import CellType

__all__ = ["macro_moments", "rho_to_density", "eos_pressure", "phi_from_density",
           "vorticity_2d"]


def macro_moments(lat: Lattice, f, rho, vel, flags, *, dx=1.0, dt=1.0):
    """Zeroth and first moments of f, frozen on OBSTACLE cells: rho = Σ_q f_q,
    vel = Σ_q f_q e_q c / rho (LBM_macro_compute_2d.py:65-92).  Returns
    (rho, vel)."""
    c = dx / dt
    is_obs = flags == int(CellType.OBSTACLE)
    rho_new = torch.where(is_obs, rho, torch.sum(f, dim=1, keepdim=True))
    moments = []
    for d in range(lat.dim):
        ed = torch.as_tensor(
            lat.e[:, d].reshape(1, lat.q, *([1] * lat.dim)).astype(np.float64),
            dtype=f.dtype, device=f.device,
        )
        moments.append(torch.sum(f * ed, dim=1, keepdim=True))
    macro_vel = torch.cat(moments, dim=1) * (c / rho_new)
    return rho_new, torch.where(is_obs, vel, macro_vel)


def rho_to_density(rho, *, rho_gas, rho_fluid, density_gas, density_fluid):
    """Linear map from order parameter rho to physical density."""
    return density_gas + (density_fluid - density_gas) * (
        (rho - rho_gas) / (rho_fluid - rho_gas)
    )


def eos_pressure(density, *, dx=1.0, dt=1.0):
    """Carnahan-Starling equation of state with a=12RT, b=4:
    p = rho RT (4 br/4 - 2 (br/4)^2) / (1 - br/4)^3 + rho RT - a rho^2."""
    c = dx / dt
    RT = c * c / 3.0
    a = 12.0 * RT
    b = 4.0
    eta = b * density / 4.0
    om = 1.0 - eta
    return (
        density * RT * (4.0 * eta - 2.0 * eta * eta) / (om * om * om)
        + density * RT
        - a * density * density
    )


def phi_from_density(density, density_gas, density_fluid):
    """The order parameter phi = -(2 (density - rho_g)/(rho_l - rho_g) - 1)
    (demo_3d_LBM_Rosensweig_instability.py:171)."""
    return -(2.0 * (density - density_gas) / (density_fluid - density_gas) - 1.0)


def vorticity_2d(vel, dx: float):
    """Central-difference vorticity (for frames only), replicate-padded to
    full size (reference: LBM_macro_compute_2d.py:109-117)."""
    vort = (
        (vel[:, 0:1, 2:, 1:-1] - vel[:, 0:1, :-2, 1:-1])
        - (vel[:, 1:2, 1:-1, 2:] - vel[:, 1:2, 1:-1, :-2])
    ) / (2.0 * dx)
    return torch.nn.functional.pad(vort, (1, 1, 1, 1), mode="replicate")
