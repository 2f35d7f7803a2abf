"""Scene builders of the port: the 3D scenes of the JAX package.

Port of ``lbm_ferrofluid_tpu/models/scenes.py``: ``multiphase_3d`` (:233),
``droplet_spread_3d`` (:256), ``two_droplets_3d`` (:279) and
``rosensweig_3d`` (:380), with ``_obstacle_frame`` and ``_apply_wall``:
geometry, flags and physics constants as the JAX builders take them from
the reference drivers.  Each returns ``(params, state)`` with the state on
the card unless ``device="cpu"``.  The 2D scenes are ROADMAP A7, the padded
transposed ``rosensweig_3d_tpu`` A8.  Resolution is ``(D, H, W) = (z, y, x)``.
"""

from __future__ import annotations

import math

import numpy as np

from ..utils.types import CellType
from .ferrofluid import init_ferrofluid_state
from .multiphase import init_hcz_state
from .params import SimulationParams

__all__ = ["multiphase_3d", "droplet_spread_3d", "two_droplets_3d", "rosensweig_3d"]

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


def _gas_box(res, batch, box=None):
    """rho and density at the gas values, with the fluid values in ``box``
    (an index into the [batch, 1, *res] arrays) when it is given."""
    rho = np.full((batch, 1, *res), _MP["rho_gas"], np.float32)
    den = np.full((batch, 1, *res), _MP["density_gas"], np.float32)
    if box is not None:
        rho[box] = _MP["rho_fluid"]
        den[box] = _MP["density_fluid"]
    return rho, den


def multiphase_3d(res=(130, 130, 130), batch=1, *, device=None):
    """Centered cube of fluid (demo_3d_LBM_multiphase.py:101-131)."""
    params = SimulationParams(
        dim=3, kappa=0.1, tau_f=0.7, tau_g=0.7,
        contact_angle=0.75 * math.pi, **_MP,
    )
    D, H, W = res
    flags = _obstacle_frame(res, batch)
    rho, den = _gas_box(res, batch, (
        Ellipsis,
        slice(int(D / 4), int(3 * D / 4)),
        slice(int(H / 4), int(3 * H / 4)),
        slice(int(W / 4), int(3 * W / 4)),
    ))
    _apply_wall(rho, den, flags)
    vel = np.zeros((batch, 3, D, H, W), np.float32)
    return params, init_hcz_state(params, rho, den, vel, flags, device=device)


def droplet_spread_3d(res=(130, 130, 130), gravity=1e-5, batch=1, *, device=None):
    """Box of fluid on the floor (demo_3d_LBM_droplet_spread.py:119-135)."""
    params = SimulationParams(
        dim=3, kappa=0.1, tau_f=0.7, tau_g=0.7, gravity=gravity,
        contact_angle=0.75 * math.pi, **_MP,
    )
    D, H, W = res
    flags = _obstacle_frame(res, batch)
    rho, den = _gas_box(res, batch, (
        Ellipsis,
        slice(int(D / 4), int(3 * D / 4)),
        slice(0, int(H / 2)),
        slice(int(W / 4), int(3 * W / 4)),
    ))
    _apply_wall(rho, den, flags)
    vel = np.zeros((batch, 3, D, H, W), np.float32)
    return params, init_hcz_state(params, rho, den, vel, flags, device=device)


def two_droplets_3d(res=(50, 50, 193), mag_strength=100.0, gravity=0.0, batch=1, *,
                    device=None):
    """Two spheres along x under a vertical field, magnetic frame closed on
    all six faces (demo_3d_LBM_two_droplets.py:115-152)."""
    params = SimulationParams(
        dim=3, kappa=0.5, tau_f=0.68, tau_g=0.68, gravity=gravity,
        contact_angle=0.5 * math.pi, mag_strength=mag_strength,
        poisson_iters=30, **_MP,
    )
    D, H, W = res
    flags = _obstacle_frame(res, batch)
    mflags = _obstacle_frame(res, batch)
    rho, den = _gas_box(res, batch)
    radius = min(res) // 4
    r = np.arange(D)[:, None, None]
    j = np.arange(H)[None, :, None]
    i = np.arange(W)[None, None, :]
    for cz, cy, cx in [(D // 2, H // 2, 3 * W // 8), (D // 2, H // 2, 5 * W // 8)]:
        ball = (r - cz) ** 2 + (j - cy) ** 2 + (i - cx) ** 2 <= radius * radius
        rho[:, 0][..., ball] = _MP["rho_fluid"]
        den[:, 0][..., ball] = _MP["density_fluid"]
    _apply_wall(rho, den, flags)
    vel = np.zeros((batch, 3, D, H, W), np.float32)
    return params, init_ferrofluid_state(params, rho, den, vel, flags, mflags,
                                         device=device)


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
    rho, den = _gas_box(res, batch, (Ellipsis, slice(None, int(0.5 * H)), slice(None)))
    _apply_wall(rho, den, flags)
    vel = np.zeros((batch, 3, D, H, W), np.float32)
    return params, init_ferrofluid_state(
        params, rho, den, vel, flags, mflags, device=device
    )
