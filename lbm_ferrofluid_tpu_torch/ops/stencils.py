"""Isotropic finite-difference stencils and staggered-grid helpers.

Twins of ``lbm_ferrofluid_tpu/ops/stencils.py``: the reference's 9-point
(2D) and 19-point (3D) isotropic gradient and Laplacian
(LBM_collision_2d.py:183-256, LBM_collision_3d.py:209-318) and the
replicate MAC-staggering helpers (utils/grid.py:7-64), on [B, C, Y, X] and
[B, C, Z, Y, X] fields: each function dispatches on the field's rank, and
pads only its spatial axes.  Replicate padding is an index clamp.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..utils.types import CellType

__all__ = [
    "fix_ring_replicate",
    "grad_ring_replicate",
    "isotropic_grad",
    "isotropic_laplacian",
    "rep_pad_interior",
    "substitute_obstacles",
    "substitute_obstacles_slab",
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


def _ring_index(n, b, device):
    """Indices that replace cells 0 and ``b - 1`` of an axis of ``n`` cells
    by cells 1 and ``b - 2``; cells past ``b - 1`` keep their own.  For
    ``b == n`` (n >= 3) this is the clamp to the interior."""
    idx = torch.arange(n, device=device)
    idx[0] = 1
    idx[b - 1] = b - 2
    return idx


def rep_pad_interior(x, bounds=None):
    """Boundary ring replaced by the nearest interior value (the reference's
    replicate pad of the interior ``x[..., 1:-1, ..., 1:-1]``) over the
    spatial axes, those after [B, C].

    ``bounds = (by, bx)`` puts the in-plane ring at the faces of a
    physical box ``[..., :by, :bx]`` of a padded 3D array
    (``params.phys_extent``): rows ``by - 1`` and columns ``bx - 1`` take
    rows ``by - 2`` and columns ``bx - 2``, cells past the box keep their
    own values, and z keeps its array ring (JAX
    ``ops/pallas/stencil3d.py:_ring_replicate_plane``)."""
    hi = x.shape[2:] if bounds is None else (x.shape[2], *bounds)
    for ax, b in zip(range(2, x.ndim), hi):
        x = torch.index_select(x, ax, _ring_index(x.shape[ax], b, x.device))
    return x


def substitute_obstacles_slab(x, flags, edges):
    """:func:`substitute_obstacles` on a z-slab of a domain decomposed along
    z (``parallel/step3d.py``): the nearest-interior values in x and y on
    every slab, and in z only at the domain's true edges (``edges =
    (bottom, top)``), where the whole domain's replicate pad binds; an
    obstacle on an inner face plane keeps its own plane, as on the whole
    domain."""
    zi = torch.arange(x.shape[2], device=x.device)
    if edges[0]:
        zi[0] = 1
    if edges[1]:
        zi[-1] = x.shape[2] - 2
    rep = torch.index_select(x, 2, zi)
    for ax in (3, 4):
        rep = torch.index_select(rep, ax, _ring_index(x.shape[ax], x.shape[ax], x.device))
    return torch.where(flags == int(CellType.OBSTACLE), rep, x)


def fix_ring_replicate(x):
    """The boundary ring overwritten with nearest-interior values: x edges
    first, then y, then z (the reference's replicate pad of the interior
    result; JAX ``ops/pallas/stencil3d.py:fix_ring_replicate``)."""
    x = x.clone()
    for ax in (-1, -2, -3):
        x.select(ax, 0).copy_(x.select(ax, 1))
        x.select(ax, -1).copy_(x.select(ax, -2))
    return x


def isotropic_grad(x, dx, flags, bounds=None):
    """Isotropic central gradient [B, 1, *res] -> [B, dim, *res].

    On OBSTACLE cells the input is first replaced by its nearest-interior
    value, the 9-point (2D) or 19-point (3D) stencil is evaluated on the
    interior and replicate-padded back out (reference:
    LBM_collision_2d.py:183-227, LBM_collision_3d.py:209-279).  With
    ``bounds`` the substitution takes its nearest-interior value at the
    physical box faces (:func:`rep_pad_interior`); the output ring stays
    at the array faces, as the TPU capillogue's box form has it."""
    if x.shape[1] != 1:
        raise ValueError("isotropic_grad expects a single-channel field")
    xn = substitute_obstacles(x, flags, bounds)
    if x.ndim == 4:
        return F.pad(torch.cat(_iso_grad_taps_2d(xn, dx), dim=1), (1, 1, 1, 1),
                     mode="replicate")
    return grad_ring_replicate(xn, dx)


def _iso_grad_taps_2d(xn, dx):
    """(gx, gy) of the 9-point isotropic stencil at the interior cells of
    ``xn`` [B, C, Y, X], each [B, C, Y-2, X-2] (LBM_collision_2d.py:183-227)."""

    def S(*off):
        return _sh(xn, off)

    gx = (4.0 * (S(0, 1) - S(0, -1)) + (S(1, 1) - S(-1, -1) + S(-1, 1) - S(1, -1))) / (12.0 * dx)
    gy = (4.0 * (S(1, 0) - S(-1, 0)) + (S(1, 1) - S(-1, -1) + S(1, -1) - S(-1, 1))) / (12.0 * dx)
    return gx, gy


def substitute_obstacles(x, flags, bounds=None):
    """``x`` with OBSTACLE cells replaced by the edge-replicated interior
    (at the box faces of ``bounds``, see :func:`rep_pad_interior`): the
    gradients' input substitution (JAX ``isotropic_grad`` and the stencil
    kernels' callers, e.g. ``solve_H_int`` :467-473)."""
    return torch.where(flags == int(CellType.OBSTACLE), rep_pad_interior(x, bounds), x)


def grad_ring_replicate(x, dx):
    """19-point isotropic gradients (gx, gy, gz) of each channel of ``x``
    [B, C, Z, Y, X] -> [B, 3C, Z, Y, X]: the stencil with replicate reads
    at every cell, then the boundary ring replaced from the interior.  For
    Z, Y, X >= 3 that is the interior stencil replicate-padded out; smaller
    axes follow the JAX package's ``grad_fields`` post-pass."""
    B, C, Z, Y, X = x.shape
    padded = F.pad(x, (1, 1, 1, 1, 1, 1), mode="replicate")
    grad = torch.stack(_iso_grad_taps(padded, dx), dim=2)
    return fix_ring_replicate(grad.reshape(B, 3 * C, Z, Y, X))


def _iso_grad_taps(xn, dx):
    """(gx, gy, gz) of the 19-point isotropic stencil at the interior cells
    of ``xn`` [B, C, Z, Y, X], each [B, C, Z-2, Y-2, X-2]."""

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
    return gx, gy, gz


def isotropic_laplacian(x, dx, bounds=None):
    """Isotropic Laplacian, zero-padded at the boundary ring: 2D
    (4·Σ_face + Σ_diag − 20·C) / (5 dx²), with the reference's /5 where an
    isotropic stencil has /6, kept for field parity
    (LBM_collision_2d.py:229-256); 3D (2·Σ_face + Σ_edge − 24·C) / (6 dx²)
    (LBM_collision_3d.py:281-318).

    With ``bounds = (by, bx)`` (3D) the in-plane zero ring lies at the
    physical box faces (rows 0 and ``by - 1``, columns 0 and ``bx - 1``),
    and cells past the box take the stencil with in-plane reads clamped to
    the array, as the TPU capillogue's box form fills them (JAX
    ``ops/pallas/capillogue.py:fill_lap``)."""
    if bounds is not None:
        Z, Y, X = x.shape[-3:]
        lap = isotropic_laplacian(F.pad(x, (1, 1, 1, 1, 0, 0), mode="replicate"), dx)
        lap = lap[..., 1:-1, 1:-1]
        y = torch.arange(Y, device=x.device).reshape(Y, 1)
        xi = torch.arange(X, device=x.device)
        ring = (y == 0) | (y == bounds[0] - 1) | (xi == 0) | (xi == bounds[1] - 1)
        return torch.where(ring, torch.zeros((), dtype=x.dtype, device=x.device), lap)

    def S(*off):
        return _sh(x, off)

    if x.ndim == 4:
        lap = (
            4.0 * (S(0, 1) + S(0, -1) + S(1, 0) + S(-1, 0))
            + (S(1, 1) + S(1, -1) + S(-1, 1) + S(-1, -1))
            - 20.0 * S(0, 0)
        ) / (5.0 * dx * dx)
        return F.pad(lap, (1, 1) * 2)
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
    """Split a vector field [B, dim, *res] into its MAC face components."""
    out = [staggered_x(vec[:, 0:1]), staggered_y(vec[:, 1:2])]
    if vec.shape[1] == 3:
        out.append(staggered_z(vec[:, 2:3]))
    return out
