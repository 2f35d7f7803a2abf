"""Scene builders of the port: the 2D and 3D scenes of the JAX package.

Port of ``lbm_ferrofluid_tpu/models/scenes.py``: ``shear_layer`` (:69),
``multiphase_drop_sc`` (:110), ``multiphase_drop_hcz`` (:119), ``wave``
(:133), ``droplet_spread_2d`` (:160), ``two_droplets_2d`` (:185),
``rosensweig_2d`` (:211), ``multiphase_3d`` (:233), ``droplet_spread_3d``
(:256), ``two_droplets_3d`` (:279) and ``rosensweig_3d`` (:380), with
``_obstacle_frame`` and ``_apply_wall``: geometry, flags and physics
constants as the JAX builders take them from the reference drivers.  Each
returns ``(params, state)`` with the state on the card unless
``device="cpu"``.  The padded transposed ``rosensweig_3d_tpu`` is ROADMAP
A8.  Resolution is ``(H, W) = (y, x)`` in 2D, ``(D, H, W) = (z, y, x)`` in
3D.
"""

from __future__ import annotations

import math

import numpy as np

from ..utils.types import CellType, KBCType
from .ferrofluid import init_ferrofluid_state
from .multiphase import init_hcz_state, init_sc_state
from .params import SimulationParams
from .singlephase import init_state as init_singlephase_state

__all__ = [
    "shear_layer", "wave", "multiphase_drop_sc", "multiphase_drop_hcz",
    "droplet_spread_2d", "two_droplets_2d", "rosensweig_2d",
    "multiphase_3d", "droplet_spread_3d", "two_droplets_3d", "rosensweig_3d",
    "phys_view",
]

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


# ---------------------------------------------------------------- 2D
def shear_layer(res=(130, 130), *, kbc: bool = False, vmax=0.2, re=3000.0, sigma=0.05,
                kappa_pert=80.0, batch=1, device=None):
    """Double shear layer + sinusoidal perturbation (demo_2d_LBM.py:80-99),
    single-phase BGK or KBC_A."""
    tau = SimulationParams.tau_from_reynolds(re, vmax, max(res))
    params = SimulationParams(dim=2, tau=tau, kbc_type=int(KBCType.KBC_A) if kbc else None)
    H, W = res
    flags = np.full((batch, 1, H, W), int(CellType.FLUID), np.uint8)
    rho = np.full((batch, 1, H, W), 0.265, np.float32)
    j = np.arange(H)[:, None]
    i = np.arange(W)[None, :]
    vel = np.zeros((batch, 2, H, W), np.float32)
    vel[:, 1] = sigma * vmax * np.sin(2.0 * np.pi * (i / W + 0.25))
    vel[:, 0] = np.where(
        j <= H / 2.0,
        vmax * np.tanh(kappa_pert * (j / H - 0.25)),
        vmax * np.tanh(kappa_pert * (-j / H + 0.75)),
    )
    return params, init_singlephase_state(params, rho, vel, flags, device=device)


def _box_drop(res, batch=1):
    """Square box of fluid in gas (demo_2d_LBM_multiphase_*.py:101-112)."""
    H, W = res
    rho, den = _gas_box(res, batch)
    r = 0.4 * max(res) / 2
    j = np.arange(H)[:, None]
    i = np.arange(W)[None, :]
    box = (np.abs(j - H / 2) <= r) & (np.abs(i - W / 2) <= r)
    rho[:, 0][..., box] = _MP["rho_fluid"]
    den[:, 0][..., box] = _MP["density_fluid"]
    return rho, den


def _drop_scene(params, res, batch, init, device):
    flags = _obstacle_frame(res, batch)
    rho, den = _box_drop(res, batch)
    _apply_wall(rho, den, flags)
    vel = np.zeros((batch, 2, *res), np.float32)
    return params, init(params, rho, den, vel, flags, device=device)


def multiphase_drop_sc(res=(130, 130), batch=1, *, device=None):
    """Shan-Chen square drop (demo_2d_LBM_multiphase_SC.py)."""
    params = SimulationParams(dim=2, tau=1.0, kappa=0.08, tau_f=0.7, tau_g=0.7, **_MP)
    return _drop_scene(params, res, batch, init_sc_state, device)


def multiphase_drop_hcz(res=(130, 130), batch=1, *, device=None):
    """HCZ square drop (demo_2d_LBM_multiphase_HCZ.py: kappa=0.1, tau 0.7/0.8,
    contact 0.75pi, KBC off)."""
    params = SimulationParams(dim=2, kappa=0.1, tau_f=0.7, tau_g=0.8,
                              contact_angle=0.75 * math.pi, **_MP)
    return _drop_scene(params, res, batch, init_hcz_state, device)


def wave(res=(130, 130), vel_max=0.2, batch=1, *, device=None):
    """Half-full pool with a velocity-forced inflow column
    (demo_2d_wave.py:96-141): KBC_A on g, contact 0.55pi, kappa=0.01; the
    inflow column's x velocity is pinned."""
    params = SimulationParams(dim=2, kappa=0.01, tau_f=0.7, tau_g=0.7,
                              contact_angle=0.55 * math.pi, kbc_type=int(KBCType.KBC_A), **_MP)
    H, W = res
    flags = _obstacle_frame(res, batch)
    rho, den = _gas_box(res, batch, (Ellipsis, slice(None, H // 2), slice(None)))
    vel = np.zeros((batch, 2, H, W), np.float32)
    vel[:, 0, :, 0] = vel_max
    pin_mask = np.zeros((batch, 2, H, W), bool)
    pin_mask[:, 0, :, 0] = True
    pin_value = np.zeros((batch, 2, H, W), np.float32)
    pin_value[:, 0, :, 0] = vel_max
    return params, init_hcz_state(params, rho, den, vel, flags, vel_pin_mask=pin_mask,
                                  vel_pin_value=pin_value, device=device)


def droplet_spread_2d(res=(130, 130), gravity=1e-5, batch=1, *, device=None):
    """Half-disc on the floor, wetting contact angle 0.75pi + gravity + KBC_A
    (demo_2d_LBM_droplet_spread.py:100-114)."""
    params = SimulationParams(dim=2, kappa=0.1, tau_f=0.7, tau_g=0.8, gravity=gravity,
                              contact_angle=0.75 * math.pi, kbc_type=int(KBCType.KBC_A),
                              **_MP)
    H, W = res
    flags = _obstacle_frame(res, batch)
    rho, den = _gas_box(res, batch)
    r = 0.6 * max(res) / 2
    j = np.arange(H)[:, None]
    i = np.arange(W)[None, :]
    disc = j * j + (i - W / 2) ** 2 <= r * r
    rho[:, 0][..., disc] = _MP["rho_fluid"]
    den[:, 0][..., disc] = _MP["density_fluid"]
    _apply_wall(rho, den, flags)
    vel = np.zeros((batch, 2, H, W), np.float32)
    return params, init_hcz_state(params, rho, den, vel, flags, device=device)


def two_droplets_2d(res=(98, 384), mag_strength=100.0, gravity=0.0, batch=1, *,
                    device=None):
    """Two discs side by side under a vertical field
    (demo_2d_LBM_two_droplets.py:101-134)."""
    params = SimulationParams(dim=2, kappa=0.5, tau_f=0.68, tau_g=0.68, gravity=gravity,
                              contact_angle=0.5 * math.pi, mag_strength=mag_strength,
                              poisson_iters=30, **_MP)
    H, W = res
    flags = _obstacle_frame(res, batch)
    mflags = _obstacle_frame(res, batch)
    rho, den = _gas_box(res, batch)
    radius = min(res) // 4
    j = np.arange(H)[:, None]
    i = np.arange(W)[None, :]
    for cy, cx in [(H // 2, 3 * W // 8), (H // 2, 5 * W // 8)]:
        disc = (j - cy) ** 2 + (i - cx) ** 2 <= radius * radius
        rho[:, 0][..., disc] = _MP["rho_fluid"]
        den[:, 0][..., disc] = _MP["density_fluid"]
    _apply_wall(rho, den, flags)
    vel = np.zeros((batch, 2, H, W), np.float32)
    return params, init_ferrofluid_state(params, rho, den, vel, flags, mflags, device=device)


def rosensweig_2d(res=(130, 130), mag_strength=100.0, gravity=1e-4, batch=1, *,
                  device=None):
    """2D Rosensweig: 45%-full pool, magnetic walls open along y, KBC_A on g
    (demo_2d_LBM_Rosensweig_instability.py:94-112)."""
    params = SimulationParams(dim=2, kappa=0.01, tau_f=0.7, tau_g=0.8, gravity=gravity,
                              contact_angle=0.75 * math.pi, mag_strength=mag_strength,
                              poisson_iters=30, kbc_type=int(KBCType.KBC_A), **_MP)
    H, W = res
    flags = _obstacle_frame(res, batch)
    mflags = np.full((batch, 1, H, W), int(CellType.OBSTACLE), np.uint8)
    mflags[..., :, 1:-1] = int(CellType.FLUID)  # open along y
    rho, den = _gas_box(res, batch, (Ellipsis, slice(None, int(0.45 * H)), slice(None)))
    _apply_wall(rho, den, flags)
    vel = np.zeros((batch, 2, H, W), np.float32)
    return params, init_ferrofluid_state(params, rho, den, vel, flags, mflags, device=device)


# ---------------------------------------------------------------- 3D
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


def phys_view(params: SimulationParams, field, vector: bool = False):
    """Physical-orientation view of a field (JAX ``scenes.phys_view``): the
    identity for states without ``phys_extent``.  The padded transposed
    layout that sets ``phys_extent`` is not ported (ROADMAP A8), so a
    ``phys_extent`` raises."""
    if params.phys_extent is None:
        return field
    raise NotImplementedError(
        "phys_view: padded transposed layouts (phys_extent) are not ported yet (ROADMAP A8)")
