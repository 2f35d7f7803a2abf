"""The y/x decomposition of the 2D models over ranks.

The port's counterpart of what GSPMD gives the JAX package's 2D paths on a
mesh with ``y`` and ``x`` axes (``lbm_ferrofluid_tpu/parallel/
sharding.py:1-13``: each ``jnp.roll`` and depth-1 stencil becomes an
exchange of 1-cell bands between devices).  Each rank holds its block
[B, C, by, bx] of the grid (``parallel/sharding.py:shard_state``); every 2D
op that reads its neighbours runs, as it is, on the block extended by
ghost cells, and its outputs are cut back to the block, bit for bit to one
device: :class:`~.blocks.Blocks` (``parallel/blocks.py``, shared with the
3D block route of ``parallel/step3d.py``), whose table :data:`HALOS` gives
each op its edge rule (``wrap`` or ``clamp``) and depth.  A 2D field is
extended once a step at :data:`MIN_DEPTH` cells or deeper, every field of
an op's extent with its own ghosts; the Poisson solve's sweeps run in
rounds of k sweeps on a k-cell halo (:meth:`Blocks.rounds`).
"""

from __future__ import annotations

from .blocks import HALOS, MIN_DEPTH, Blocks, mag_boundary_only
from .mesh import Mesh

__all__ = ["HALOS", "MIN_DEPTH", "Blocks", "blocks", "mag_boundary_only"]


def blocks(mesh: Mesh, f) -> Blocks:
    """This rank's :class:`Blocks` for a step of the 2D state whose f is
    ``f``; raises for a mesh a 2D state does not split over."""
    if mesh.nz > 1 or mesh.slab:
        raise NotImplementedError(
            f"a 2D state on a mesh with a z axis (z={mesh.nz}, slab={mesh.slab}): 2D states "
            "split along y and x, 3D states along z, y and x; make the mesh over "
            "('batch', 'y', 'x')")
    return Blocks(mesh, tuple(f.shape[-2:]))
