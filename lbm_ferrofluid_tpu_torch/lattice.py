"""Lattice definitions of the PyTorch/CUDA port.

A :class:`Lattice` is static data: velocity sets, quadrature weights and the
opposite-direction (bounce-back) permutation, as host-side numpy constants.
The tables are float64 and equal, entry for entry, the JAX package's
(``lbm_ferrofluid_tpu/lattice.py``); this module is a copy so that the port
imports nothing of that package.  Code that computes in float32 rounds the
weights to float32 at the point of use, as the JAX ops do
(``w_bcast(np.float64)`` cast to the field dtype).

Velocity-set ordering matches the reference solver exactly so that golden
parity tests can compare distribution functions component-by-component
(reference: src/LBM/LBM_macro_compute/LBM_macro_compute_2d.py:38-49 for D2Q9,
src/LBM/LBM_collision/LBM_collision_3d.py:46-103 for D3Q19).

Array layout convention (shared with the JAX package):

* distribution functions ``f``: ``[B, Q, (z,) y, x]``
* vector fields (velocity, force): ``[B, dim, (z,) y, x]`` with components
  ordered ``(x, y[, z])`` along the channel axis,
* scalar fields: ``[B, 1, (z,) y, x]``.

The minor-most (contiguous) array axis is x; the channel axis carries
(x, y, z) components in that order.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np

__all__ = ["Lattice", "D2Q9", "D3Q19", "get_lattice"]


@dataclasses.dataclass(frozen=True)
class Lattice:
    """Static description of a DdQq lattice."""

    name: str
    dim: int
    q: int
    weights: np.ndarray  # [Q] float64
    e: np.ndarray  # [Q, dim] int64, components ordered (x, y[, z])
    opposite: np.ndarray  # [Q] int64, e[opposite[i]] == -e[i]

    def __post_init__(self):
        assert self.e.shape == (self.q, self.dim)
        assert abs(self.weights.sum() - 1.0) < 1e-12
        assert (self.e[self.opposite] == -self.e).all()

    # ------------------------------------------------------------------
    # Broadcast helpers.  These return numpy constants shaped so they
    # broadcast directly against [B, Q, *res] / [B, Q, dim, *res] arrays.
    # ------------------------------------------------------------------
    def w_bcast(self, dtype=np.float32) -> np.ndarray:
        """Weights shaped [1, Q, 1, ..., 1] for [B, Q, *res] broadcasting."""
        return self.weights.astype(dtype).reshape(1, self.q, *([1] * self.dim))

    def shifts(self) -> list[tuple[int, ...]]:
        """Per-direction spatial roll shifts in array-axis order.

        The spatial axes of our arrays are ordered ``((z,) y, x)`` while the
        lattice velocity components are ordered ``(x, y(, z))``; this reverses
        the component order so ``shifts()[q]`` can be passed straight to
        ``torch.roll(..., dims=(-dim, ..., -1))``.
        """
        return [tuple(int(c) for c in ev[::-1]) for ev in self.e]

    def __hash__(self):
        return hash((self.name, self.dim, self.q))

    def __eq__(self, other):
        return isinstance(other, Lattice) and self.name == other.name


# ----------------------------------------------------------------------
# D2Q9 — ordering: rest; +x, +y, -x, -y; (+x+y), (-x+y), (-x-y), (+x-y)
# (reference: LBM_collision_2d.py:46-83)
# ----------------------------------------------------------------------
_E2 = np.array(
    [
        [0, 0],
        [1, 0],
        [0, 1],
        [-1, 0],
        [0, -1],
        [1, 1],
        [-1, 1],
        [-1, -1],
        [1, -1],
    ],
    dtype=np.int64,
)
_W2 = np.array([4.0 / 9.0] + [1.0 / 9.0] * 4 + [1.0 / 36.0] * 4, dtype=np.float64)
_OPP2 = np.array([0, 3, 4, 1, 2, 7, 8, 5, 6], dtype=np.int64)

D2Q9 = Lattice(name="D2Q9", dim=2, q=9, weights=_W2, e=_E2, opposite=_OPP2)

# ----------------------------------------------------------------------
# D3Q19 — ordering: rest; in-plane D2Q9-like 8; +z; 4 (+z diagonals);
# -z; 4 (-z diagonals)   (reference: LBM_collision_3d.py:46-103)
# ----------------------------------------------------------------------
_E3 = np.array(
    [
        [0, 0, 0],
        [1, 0, 0],
        [0, 1, 0],
        [-1, 0, 0],
        [0, -1, 0],
        [1, 1, 0],
        [-1, 1, 0],
        [-1, -1, 0],
        [1, -1, 0],
        [0, 0, 1],
        [1, 0, 1],
        [0, 1, 1],
        [-1, 0, 1],
        [0, -1, 1],
        [0, 0, -1],
        [1, 0, -1],
        [0, 1, -1],
        [-1, 0, -1],
        [0, -1, -1],
    ],
    dtype=np.int64,
)
_W3 = np.array(
    [1.0 / 3.0]
    + [1.0 / 18.0] * 4
    + [1.0 / 36.0] * 4
    + [1.0 / 18.0]
    + [1.0 / 36.0] * 4
    + [1.0 / 18.0]
    + [1.0 / 36.0] * 4,
    dtype=np.float64,
)
# opposite map (reference: LBM_propagation_3d.py:113-142)
_OPP3 = np.array(
    [0, 3, 4, 1, 2, 7, 8, 5, 6, 14, 17, 18, 15, 16, 9, 12, 13, 10, 11],
    dtype=np.int64,
)

D3Q19 = Lattice(name="D3Q19", dim=3, q=19, weights=_W3, e=_E3, opposite=_OPP3)


@lru_cache(maxsize=None)
def get_lattice(dim: int) -> Lattice:
    """Return the canonical lattice for a spatial dimension (2 -> D2Q9, 3 -> D3Q19)."""
    if dim == 2:
        return D2Q9
    if dim == 3:
        return D3Q19
    raise ValueError(f"unsupported dimension: {dim}")
