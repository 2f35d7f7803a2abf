"""Isotropic finite-difference stencils and staggered-grid helpers, 3D.

Twins of ``lbm_ferrofluid_tpu/ops/stencils.py``: the reference's 19-point
isotropic gradient and Laplacian (LBM_collision_3d.py:209-318) and the
replicate MAC-staggering helpers (utils/grid.py:7-64), on [B, C, Z, Y, X]
fields.  Replicate padding is an index clamp.  The 2D forms are ROADMAP A7.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..utils.types import CellType

__all__ = [
    "isotropic_grad",
    "isotropic_laplacian",
    "rep_pad_interior",
    "staggered_x",
    "staggered_y",
    "staggered_z",
    "staggered",
]


def _sh(x, off):
    """Interior view of ``x`` shifted by ``off`` (array-axis order z, y, x)."""
    idx = [slice(None)] * (x.ndim - len(off))
    for o in off:
        idx.append(slice(1 + o, None if o == 1 else -1 + o))
    return x[tuple(idx)]


def rep_pad_interior(x):
    """Boundary ring replaced by the nearest interior value (the reference's
    replicate pad of ``x[..., 1:-1, 1:-1, 1:-1]``)."""
    for ax in range(x.ndim - 3, x.ndim):
        n = x.shape[ax]
        idx = torch.clamp(torch.arange(n, device=x.device), 1, n - 2)
        x = torch.index_select(x, ax, idx)
    return x


def _replicate_pad(x):
    """Replicate-pad an interior-sized field by one cell per side."""
    for ax in range(x.ndim - 3, x.ndim):
        n = x.shape[ax]
        idx = torch.clamp(torch.arange(n + 2, device=x.device) - 1, 0, n - 1)
        x = torch.index_select(x, ax, idx)
    return x


def isotropic_grad(x, dx, flags):
    """Isotropic central gradient [B, 1, Z, Y, X] -> [B, 3, Z, Y, X].

    On OBSTACLE cells the input is first replaced by its nearest-interior
    value, the 19-point stencil is evaluated on the interior and replicate-
    padded back out (reference: LBM_collision_3d.py:209-279)."""
    if x.shape[1] != 1:
        raise ValueError("isotropic_grad expects a single-channel field")
    xn = torch.where(flags == int(CellType.OBSTACLE), rep_pad_interior(x), x)

    def S(*off):
        return _sh(xn, off)

    gx = (
        2.0 * (S(0, 0, 1) - S(0, 0, -1))
        + (
            S(1, 0, 1) - S(-1, 0, -1) + S(-1, 0, 1) - S(1, 0, -1)
            + S(0, 1, 1) - S(0, -1, -1) + S(0, -1, 1) - S(0, 1, -1)
        )
    ) / (12.0 * dx)
    gy = (
        2.0 * (S(0, 1, 0) - S(0, -1, 0))
        + (
            S(1, 1, 0) - S(-1, -1, 0) + S(-1, 1, 0) - S(1, -1, 0)
            + S(0, 1, 1) - S(0, -1, -1) + S(0, 1, -1) - S(0, -1, 1)
        )
    ) / (12.0 * dx)
    gz = (
        2.0 * (S(1, 0, 0) - S(-1, 0, 0))
        + (
            S(1, 1, 0) - S(-1, -1, 0) + S(1, -1, 0) - S(-1, 1, 0)
            + S(1, 0, 1) - S(-1, 0, -1) + S(1, 0, -1) - S(-1, 0, 1)
        )
    ) / (12.0 * dx)
    return _replicate_pad(torch.cat([gx, gy, gz], dim=1))


def isotropic_laplacian(x, dx):
    """19-point Laplacian (2·Σ_face + Σ_edge − 24·C) / (6 dx²), zero-padded
    at the boundary ring (reference: LBM_collision_3d.py:281-318)."""

    def S(*off):
        return _sh(x, off)

    faces = (
        S(0, 0, 1) + S(0, 0, -1) + S(0, 1, 0) + S(0, -1, 0)
        + S(1, 0, 0) + S(-1, 0, 0)
    )
    edges = (
        S(0, 1, 1) + S(0, 1, -1) + S(0, -1, 1) + S(0, -1, -1)
        + S(1, 0, 1) + S(1, 0, -1) + S(-1, 0, 1) + S(-1, 0, -1)
        + S(1, 1, 0) + S(1, -1, 0) + S(-1, 1, 0) + S(-1, -1, 0)
    )
    lap = (2.0 * faces + edges - 24.0 * S(0, 0, 0)) / (6.0 * dx * dx)
    return F.pad(lap, (1, 1) * 3)


# ----------------------------------------------------------------------
# MAC staggering (reference: utils/grid.py:7-64): face-centered averages
# along one axis, padded by one face on each side.
# ----------------------------------------------------------------------
def _stagger(x, axis):
    n = x.shape[axis]
    avg = 0.5 * (x.narrow(axis, 1, n - 1) + x.narrow(axis, 0, n - 1))
    idx = torch.clamp(torch.arange(n + 1, device=x.device) - 1, 0, n - 2)
    return torch.index_select(avg, axis % x.ndim, idx)


def staggered_x(x):
    return _stagger(x, -1)


def staggered_y(x):
    return _stagger(x, -2)


def staggered_z(x):
    return _stagger(x, -3)


def staggered(vec):
    """Split a vector field [B, 3, Z, Y, X] into its MAC face components."""
    return [staggered_x(vec[:, 0:1]), staggered_y(vec[:, 1:2]),
            staggered_z(vec[:, 2:3])]
