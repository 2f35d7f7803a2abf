"""Scene builders of the port (the 3D Rosensweig instability so far).

Port of ``lbm_ferrofluid_tpu/models/scenes.py:rosensweig_3d`` (:380) with
``_obstacle_frame`` and ``_apply_wall``: geometry, flags and physics
constants taken from the reference driver
(demo_3d_LBM_Rosensweig_instability.py:115-149).  The other scenes are
ROADMAP A5/A7.  Resolution is ``(D, H, W) = (z, y, x)``.
"""

from __future__ import annotations

import math

import numpy as np

from ..utils.types import CellType
from .ferrofluid import init_ferrofluid_state
from .params import SimulationParams

__all__ = ["rosensweig_3d"]

# the multiphase demos share one fluid (reference: demo_*_HCZ.py headers)
_MP = dict(
    density_gas=0.02381,
    density_fluid=0.2508,
    rho_gas=0.02381,
    rho_fluid=0.2508,
)
_WALL_RHO = 0.2508
_WALL_DEN = 0.2508


def _obstacle_frame(res, batch=1):
    """All-FLUID domain wrapped in a 1-cell OBSTACLE frame."""
    flags = np.full((batch, 1, *res), int(CellType.OBSTACLE), np.uint8)
    inner = (Ellipsis,) + tuple(slice(1, -1) for _ in res)
    flags[inner] = int(CellType.FLUID)
    return flags


def _apply_wall(rho, density, flags):
    obs = flags == int(CellType.OBSTACLE)
    rho[obs] = _WALL_RHO
    density[obs] = _WALL_DEN
    return rho, density


def rosensweig_3d(res=(130, 66, 130), mag_strength=100.0, gravity=1e-4, batch=1,
                  *, device=None):
    """North-star scene: pool at y < 0.5, field along y, magnetic domain open
    in y.  Returns ``(params, state)``; the state lives on the card unless
    ``device="cpu"``."""
    params = SimulationParams(
        dim=3, kappa=0.01, tau_f=0.68, tau_g=0.68, gravity=gravity,
        contact_angle=0.5 * math.pi, mag_strength=mag_strength,
        poisson_iters=30, mag_flags_shell=True, **_MP,
    )
    D, H, W = res
    flags = _obstacle_frame(res, batch)
    mflags = np.full((batch, 1, D, H, W), int(CellType.OBSTACLE), np.uint8)
    mflags[..., 1:-1, :, 1:-1] = int(CellType.FLUID)
    rho = np.full((batch, 1, D, H, W), _MP["rho_gas"], np.float32)
    den = np.full((batch, 1, D, H, W), _MP["density_gas"], np.float32)
    rho[..., : int(0.5 * H), :] = _MP["rho_fluid"]
    den[..., : int(0.5 * H), :] = _MP["density_fluid"]
    _apply_wall(rho, den, flags)
    vel = np.zeros((batch, 3, D, H, W), np.float32)
    return params, init_ferrofluid_state(
        params, rho, den, vel, flags, mflags, device=device
    )
