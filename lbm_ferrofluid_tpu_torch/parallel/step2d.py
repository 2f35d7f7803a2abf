"""The y/x decomposition of the 2D models over ranks.

The port's counterpart of what GSPMD gives the JAX package's 2D paths on a
mesh with ``y`` and ``x`` axes (``lbm_ferrofluid_tpu/parallel/
sharding.py:1-13``: each ``jnp.roll`` and depth-1 stencil becomes an
exchange of 1-cell bands between devices).  Each rank holds its block
[B, C, by, bx] of the grid (``parallel/sharding.py:shard_state``); every 2D
op that reads its neighbours runs, as it is, on the block extended by
ghost cells (:meth:`Blocks.op`), and its outputs are cut back to the
block.  A cell's arithmetic is the one device's and only where its
neighbours come from changes, so a meshed step equals the one-device step
bit for bit.  The ops that read no neighbour (the collisions, the moments,
the maps) run on the block as they are.

Each op has one of two edge rules (:data:`HALOS`), with a depth:

* ``wrap``: ops built on ``torch.roll`` (streaming, the Poisson sweeps, the
  wall weights) wrap the whole domain, so the ghosts past the domain's
  edges come from the ranks at its other side;
* ``clamp``: ops that pad or rewrite at the array faces (the isotropic
  gradient's obstacle substitution and replicate ring, the Laplacian's
  zero ring, the Shan-Chen zero pad, the contact-angle surgery, the
  staggered differences' clamps) must meet the domain's faces where the
  domain has them: the extension stops at the domain's edges, so a face of
  the extended block is a true face, where the op applies its own rule as
  on one device, or an inner one ``depth`` cells from the block, whose
  wrong cells the cut drops.  The depth of 3 covers a block one cell thin
  at a true face: the face cell takes its value from the cell one in (the
  replicate ring, the surgery's corners), which reads one further.

The ghosts come by :func:`~.halo.ring_halo`, along y first, then along x
over the block already extended in y, so that the corners (D2Q9's
diagonals) come from the diagonal ranks; a block thinner than the depth
takes them in rounds, each from the neighbours' extended block, so a band
can cross several ranks.  Fields of one dtype travel in one exchange, and
each field is extended once a step (:class:`Blocks` keeps the deepest
extension, and cuts shallower ones from it).  The Poisson sweeps run in
rounds of k sweeps on a halo of k cells (:meth:`Blocks.rounds`); at k = 1
that is one exchange a sweep.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops.collide import contact_angle_boundary, hcz_capillary, sc_collide
from ..ops.magnetic import channel_sweeps_2d, h_int_from_psi, poisson_rhs_scaled
from ..ops.scalar_poisson import make_cmask, s_prev_from_h, scalar_sweeps_exact
from ..ops.stream import stream, stream_bounce_macro, stream_bounce_moments
from ..utils.types import CellType
from .halo import ring_halo
from .mesh import Mesh

__all__ = ["HALOS", "MIN_DEPTH", "Blocks", "blocks", "mag_boundary_only"]

WRAP, CLAMP = "wrap", "clamp"

#: each 2D op that reads its neighbours: its edge rule and its halo depth
#: (None: the sweeps of a round, :meth:`Blocks.rounds`)
HALOS = {
    stream: (WRAP, 1),
    stream_bounce_moments: (WRAP, 1),
    stream_bounce_macro: (WRAP, 1),
    scalar_sweeps_exact: (WRAP, None),
    channel_sweeps_2d: (WRAP, None),
    s_prev_from_h: (WRAP, 1),
    make_cmask: (WRAP, 1),
    sc_collide: (CLAMP, 1),
    poisson_rhs_scaled: (CLAMP, 1),
    contact_angle_boundary: (CLAMP, 3),
    hcz_capillary: (CLAMP, 3),
    h_int_from_psi: (CLAMP, 3),
}

#: the depth a field is first extended to: its later uses at the depths of
#: :data:`HALOS` then cut their ghosts from that extension
MIN_DEPTH = 3

def blocks(mesh: Mesh, f: torch.Tensor) -> Blocks:
    """This rank's :class:`Blocks` for a step of the 2D state whose f is
    ``f``; raises for a mesh a 2D state does not split over."""
    if mesh.nz > 1 or mesh.slab:
        raise NotImplementedError(
            f"a 2D state on a mesh with a z axis (z={mesh.nz}, slab={mesh.slab}): 2D states "
            "split along y and x, 3D states along z; make the mesh over "
            "('batch', 'y', 'x')")
    return Blocks(mesh, tuple(f.shape[-2:]))


class Blocks:
    """This rank's block of a 2D domain on a y/x mesh, for one step: its
    place, the exchanges that extend a field by ghost cells, and the
    extensions made so far (each field's deepest, kept until the step
    ends)."""

    def __init__(self, mesh: Mesh, block):
        self.mesh = mesh
        self.block = tuple(block)
        if self.block == (1, 1):
            raise ValueError(
                "a block of 1x1 cells a rank: the decomposed ops tell a field from a "
                "per-channel constant ([B, C, 1, 1], as the gravity vector) by its extent; "
                "use fewer ranks along y or x")
        by, bx = self.block
        #: per spatial dim (2: y, 3: x): (mesh axis, block extent, first cell, domain extent)
        self.axes = {2: ("y", by, mesh.iy * by, mesh.ny * by),
                     3: ("x", bx, mesh.ix * bx, mesh.nx * bx)}
        self._ext = {}

    # -- ghosts -------------------------------------------------------------
    def _axis_wrap(self, x, dim, g):
        """``x`` with ``g`` wrapped ghost cells a side along ``dim``."""
        axis, n, _, _ = self.axes[dim]
        lo = hi = x.narrow(dim, 0, 0)
        d = 0
        while d < g:
            k = min(n, g - d)
            # the rank above needs the k cells below its d-deep lower band,
            # the rank below the k cells above its upper band
            up = torch.cat([lo, x], dim).narrow(dim, n - k, k)
            dn = torch.cat([x, hi], dim).narrow(dim, d, k)
            lo = torch.cat([ring_halo(up, self.mesh, +1, axis), lo], dim)
            hi = torch.cat([hi, ring_halo(dn, self.mesh, -1, axis)], dim)
            d += k
        return torch.cat([lo, x, hi], dim)

    def _extend_all(self, xs, g):
        """The wrap extensions by ``g`` of the block fields ``xs``: one
        exchange a side and axis (and round) for the fields of each dtype."""
        out = [None] * len(xs)
        by_dtype = {}
        for i, x in enumerate(xs):
            by_dtype.setdefault((x.dtype, x.shape[0]), []).append(i)
        for idx in by_dtype.values():
            parts = [xs[i] for i in idx]
            sizes = [p.shape[1] for p in parts]
            x = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
            for dim in (2, 3):
                x = self._axis_wrap(x, dim, g)
            for i, p in zip(idx, torch.split(x, sizes, dim=1)):
                out[i] = p
        return out

    def _view(self, ext, G, g, mode):
        """The extension by ``g`` under ``mode`` cut from a wrap extension
        by ``G >= g``: at a true edge a clamp keeps no ghost past it."""
        for dim, (_, n, c0, N) in self.axes.items():
            lo, hi = (g, g) if mode == WRAP else (min(g, c0), min(g, N - c0 - n))
            ext = ext.narrow(dim, G - lo, lo + n + hi)
        return ext.contiguous()

    def extend(self, xs, g, mode):
        """The block fields ``xs`` extended by ``g`` ghost cells under
        ``mode`` (``"wrap"`` or ``"clamp"``); each field's extension made
        once, at :data:`MIN_DEPTH` or deeper."""
        need = [x for x in xs if self._ext.get(id(x), (None, -1, None))[1] < g]
        if need:
            G = max(g, MIN_DEPTH)
            for x, e in zip(need, self._extend_all(need, G)):
                self._ext[id(x)] = (x, G, e)
        return [self._view(self._ext[id(x)][2], self._ext[id(x)][1], g, mode) for x in xs]

    def cut(self, y, g, mode):
        """The block's cells of an output ``y`` of an op run on the
        extension by ``g`` under ``mode``."""
        for dim, (_, n, c0, _) in self.axes.items():
            y = y.narrow(dim, g if mode == WRAP else min(g, c0), n)
        return y.contiguous()

    # -- ops ----------------------------------------------------------------
    def op(self, fn, depth=None):
        """``fn`` (a key of :data:`HALOS`) on this rank's block: its block
        fields (the tensor arguments of the block's extent) extended by the
        op's halo, its outputs of the extension's extent cut back to the
        block.  ``depth`` overrides the table's (the sweeps of a round)."""
        mode, d = HALOS[fn]
        g = d if depth is None else depth

        def run(*args, **kw):
            fields = [a for a in (*args, *kw.values()) if self._is_field(a)]
            if not fields:
                raise ValueError(f"{fn.__name__}: no field of the block's extent {self.block}")
            ext = dict(zip(map(id, fields), self.extend(fields, g, mode)))
            args = [ext.get(id(a), a) if self._is_field(a) else a for a in args]
            kw = {k: ext.get(id(v), v) if self._is_field(v) else v for k, v in kw.items()}
            shape = ext[id(fields[0])].shape[-2:]
            return _map_out(fn(*args, **kw), lambda y: self.cut(y, g, mode)
                            if isinstance(y, torch.Tensor) and y.shape[-2:] == shape else y)

        return run

    def _is_field(self, a):
        return isinstance(a, torch.Tensor) and a.ndim == 4 and tuple(a.shape[-2:]) == self.block

    def rounds(self, n_iters):
        """The sweeps of each round of an ``n_iters``-sweep solve: one
        exchange of a k-cell halo, then k sweeps on the extended block, k
        an eighth of the block's thinner side (at least 1, at most
        ``n_iters``), which keeps the cells computed twice under a
        quarter more."""
        k = max(1, min(min(self.block) // 8, n_iters))
        return [k] * (n_iters // k) + ([n_iters % k] if n_iters % k else [])


def _map_out(value, fn):
    if isinstance(value, (tuple, list)):
        return type(value)(_map_out(v, fn) for v in value)
    return fn(value)


def mag_boundary_only(blk: Blocks, magnetic_flags) -> bool:
    """``models/ferrofluid.py:_mag_boundary_only`` of the whole domain from
    the ranks' blocks: no magnetic obstacle off the domain's outermost ring
    on any rank (one all-reduce)."""
    inner = magnetic_flags == int(CellType.OBSTACLE)
    for dim, (_, n, c0, N) in blk.axes.items():
        cells = torch.arange(c0, c0 + n, device=inner.device)
        shape = [1] * inner.ndim
        shape[dim] = n
        inner = inner & ((cells > 0) & (cells < N - 1)).reshape(shape)
    found = torch.tensor([int(inner.any())], dtype=torch.int32,
                         device=blk.mesh.device if blk.mesh.backend == "nccl" else "cpu")
    dist.all_reduce(found, op=dist.ReduceOp.MAX)
    return not bool(found.item())

