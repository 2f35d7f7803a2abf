"""The decomposition of a 2D or 3D grid into blocks over ranks.

The port's counterpart of what GSPMD gives the JAX package's paths on a
mesh with spatial axes (``lbm_ferrofluid_tpu/parallel/sharding.py:1-13``:
each ``jnp.roll`` and stencil becomes an exchange of bands between
devices).  Each rank holds its block [B, C, (bz,) by, bx] of the grid
(``parallel/sharding.py:shard_state``); every op that reads its neighbours
runs, as it is, on the block extended by ghost cells (:meth:`Blocks.op`),
and its outputs are cut back to the block.  A cell's arithmetic is the one
device's and only where its neighbours come from changes, so a step on
blocks equals the one-device step bit for bit.  The ops that read no
neighbour (the collisions, the maps) run on the block as they are.  2D
states split along y and x (``parallel/step2d.py``), 3D states along z, y
and x (``parallel/step3d.py``, the block route); on the card the 3D ops are
the single-device kernels themselves, run on the extended blocks.

Each op has one of two edge rules (:data:`HALOS`), with a depth:

* ``wrap``: ops built on periodic pulls (streaming, the Poisson sweeps, the
  wall weights, the kernels B4, B5, B8a, B8b, B1's and B11b's passes) wrap
  the whole domain, so the ghosts past the domain's edges come from the
  ranks at its other side;
* ``clamp``: ops that pad or rewrite at the array faces (the isotropic
  gradient's obstacle substitution and replicate ring, the Laplacian's zero
  ring, the Shan-Chen zero pad, the contact-angle surgery, the staggered
  differences' clamps; the kernels B1's H2 launch, B2, B6 and B10a) must
  meet the domain's faces where the domain has them: the extension stops at
  the domain's edges, so a face of the extended block is a true face, where
  the op applies its own rule as on one device, or an inner one ``depth``
  cells from the block, whose wrong cells the cut drops.  The depth of 3
  covers a block one cell thin at a true face: the face cell takes its
  value from the cell one in (the replicate ring, the surgery's corners and
  D3Q19's edge lines), which reads one further, and a wrong value at an
  inner face reaches two cells in (a ring rule, then a stencil over it).

An entry may name the arguments whose ghosts matter (the streamed
distributions of B4, B5, B8a and B8b, the stencil inputs of B6); its other
block fields are padded locally by their edge cells, since only the ghost
cells' own outputs, which the cut drops, read them.

The ghosts come by :func:`~.halo.ring_halo` along each axis with more than
one rank, z first, then y, then x over the block already extended, so that
the edges and corners (D3Q19's and D2Q9's diagonals) come from the
diagonal ranks; a block thinner than the depth takes them in rounds, each
from the neighbours' extended block, so a band can cross several ranks.  An
axis of one rank takes no ghosts: its ops wrap or meet its faces on the
whole domain's extent.  Fields of one dtype travel in one exchange (the
rank's batch elements with them: its bytes grow with the batch, not the
count of exchanges), and each field is extended once a step
(:class:`Blocks` keeps the deepest extension, and cuts shallower ones from
it).  The Poisson sweeps run in
rounds of k sweeps on a halo of k cells (:meth:`Blocks.rounds`).
"""

from __future__ import annotations

import functools
import inspect

import torch
import torch.distributed as dist

from ..ops.collide import bgk_collide, contact_angle_boundary, hcz_capillary, sc_collide
from ..ops.kernels.capmac import hcz_capillary_gradmac, hcz_capillary_gradmac_plain
from ..ops.kernels.contact3d import contact_angle_3d, contact_angle_3d_plain
from ..ops.kernels.fused_step import (
    lbm_epilogue,
    lbm_epilogue_plain,
    lbm_prologue,
    lbm_prologue_plain,
)
from ..ops.kernels.hcz3d import hcz_collide_fused, hcz_collide_fused_plain
from ..ops.kernels.poisson import poisson_sweeps, poisson_sweeps_plain
from ..ops.kernels.scalar_poisson import (
    h2_from_psi_plain,
    scalar_h2,
    scalar_wavefront,
    scalar_wavefront_plain,
)
from ..ops.kernels.stream3d import stream_bounce_macro as b8b
from ..ops.kernels.stream3d import stream_bounce_macro_plain as b8b_plain
from ..ops.kernels.stream3d import stream_bounce_moments as b8a
from ..ops.kernels.stream3d import stream_bounce_moments_plain as b8a_plain
from ..ops.magnetic import channel_sweeps_2d, h_int_from_psi, poisson_rhs_scaled
from ..ops.moments import phi_from_density, rho_to_density
from ..ops.scalar_poisson import make_cmask, s_prev_from_h, scalar_sweeps_exact
from ..ops.stream import stream, stream_bounce_macro, stream_bounce_moments
from ..utils.types import CellType
from .halo import ring_halo
from .mesh import Mesh

__all__ = ["HALOS", "MIN_DEPTH", "WRAP", "CLAMP", "LOCAL", "Blocks", "interior",
           "any_rank", "mag_boundary_only"]

WRAP, CLAMP, LOCAL = "wrap", "clamp", "local"

_FG = ("f", "g")
_CAPMAC_STENCIL = ("rho_pre", "density_pre", "pressure", "rho_ca", "phi", "flags")

#: each op of a step on blocks: its edge rule, its halo depth (None: the
#: sweeps of a round, :meth:`Blocks.rounds`) and, where only some of its
#: block fields need real ghosts, their argument names; ``local`` ops take
#: no ghosts and run on the block as they are
HALOS = {
    # 2D and 3D plain ops
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
    bgk_collide: (LOCAL, 0),
    phi_from_density: (LOCAL, 0),
    rho_to_density: (LOCAL, 0),
    # the 3D kernels (ops/kernels) and their plain versions
    lbm_prologue: (WRAP, 1, _FG),
    lbm_prologue_plain: (WRAP, 1, _FG),
    lbm_epilogue: (WRAP, 1, _FG),
    lbm_epilogue_plain: (WRAP, 1, _FG),
    b8a: (WRAP, 1, ("f",)),
    b8a_plain: (WRAP, 1, ("f",)),
    b8b: (WRAP, 1, ("f",)),
    b8b_plain: (WRAP, 1, ("f",)),
    scalar_wavefront: (WRAP, None),
    scalar_wavefront_plain: (WRAP, None),
    scalar_h2: (CLAMP, 3),
    h2_from_psi_plain: (CLAMP, 3),
    poisson_sweeps: (WRAP, None),
    poisson_sweeps_plain: (WRAP, None),
    contact_angle_3d: (CLAMP, 3),
    contact_angle_3d_plain: (CLAMP, 3),
    hcz_capillary_gradmac: (CLAMP, 3, _CAPMAC_STENCIL),
    hcz_capillary_gradmac_plain: (CLAMP, 3, _CAPMAC_STENCIL),
    hcz_collide_fused: (LOCAL, 0),
    hcz_collide_fused_plain: (LOCAL, 0),
}

#: the depth a 2D field is first extended to: its later uses at the depths
#: of :data:`HALOS` then cut their ghosts from that extension (a 3D step
#: extends each field at its first use's depth, and prefetches deeper
#: ones, :meth:`Blocks.extend`, since its f and g take one cell only)
MIN_DEPTH = 3


@functools.lru_cache(maxsize=None)
def _signature(fn):
    return inspect.signature(fn)


class Blocks:
    """This rank's block of a 2D or 3D domain on a mesh, for one step: its
    place, the exchanges that extend a field by ghost cells, and the
    extensions made so far (each field's deepest, kept until the step
    ends).  ``block`` is the block's (bz,) by, bx; ``min_depth`` the depth
    a field is first extended to."""

    def __init__(self, mesh: Mesh, block, min_depth: int = MIN_DEPTH):
        self.mesh = mesh
        self.block = tuple(block)
        self.min_depth = min_depth
        if all(n == 1 for n in self.block):
            raise ValueError(
                f"a block of {'x'.join(['1'] * len(self.block))} cells a rank: the decomposed "
                "ops tell a field from a per-channel constant ([B, C, 1, ...], as the "
                "gravity vector) by its extent; use fewer ranks along the spatial axes")
        names = ("z", "y", "x")[3 - len(self.block):]
        #: per spatial dim (2: z in 3D, y in 2D, ...): (mesh axis, block
        #: extent, first cell, domain extent)
        self.axes = {2 + i: (name, n, mesh.coords.get(name, 0) * n,
                             mesh.sizes.get(name, 1) * n)
                     for i, (name, n) in enumerate(zip(names, self.block))}
        #: the dims split over more than one rank, the only ones extended
        self.split = {d: a for d, a in self.axes.items() if a[3] > a[1]}
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
            for dim in self.split:
                x = self._axis_wrap(x, dim, g)
            for i, p in zip(idx, torch.split(x, sizes, dim=1)):
                out[i] = p
        return out

    def _sides(self, dim, g, mode):
        """Ghost cells (below, above) along ``dim`` of the extension by
        ``g`` under ``mode``: at a true edge a clamp keeps none past it."""
        _, n, c0, N = self.split[dim]
        return (g, g) if mode == WRAP else (min(g, c0), min(g, N - c0 - n))

    def origin(self, g, mode):
        """The whole domain's coordinates of the first cell of an extension
        by ``g`` under ``mode``, per spatial dim."""
        return tuple(c0 - self._sides(d, g, mode)[0] if d in self.split else 0
                     for d, (_, _, c0, _) in self.axes.items())

    def view(self, ext, G, g, mode):
        """The extension by ``g`` under ``mode`` cut from a wrap extension
        by ``G >= g``."""
        for dim in self.split:
            lo, hi = self._sides(dim, g, mode)
            ext = ext.narrow(dim, G - lo, lo + self.split[dim][1] + hi)
        return ext.contiguous()

    def pad(self, x, g, mode):
        """The block field ``x`` extended as by ``g`` under ``mode``, its
        ghosts its own edge cells (no exchange): for the fields an op reads
        only at the cell it writes."""
        for dim in self.split:
            lo, hi = self._sides(dim, g, mode)
            n = self.split[dim][1]
            idx = torch.clamp(torch.arange(-lo, n + hi, device=x.device), 0, n - 1)
            x = x.index_select(dim, idx)
        return x

    def extend(self, xs, g, mode=WRAP):
        """The block fields ``xs`` extended by ``g`` ghost cells under
        ``mode`` (``"wrap"`` or ``"clamp"``); each field's extension made
        once, at ``min_depth`` or deeper (a caller that will need a field
        deeper later asks for that depth first)."""
        need = [x for x in xs if self._ext.get(id(x), (None, -1, None))[1] < g]
        if need:
            G = max(g, self.min_depth)
            for x, e in zip(need, self._extend_all(need, G)):
                self._ext[id(x)] = (x, G, e)
        return [self.view(self._ext[id(x)][2], self._ext[id(x)][1], g, mode) for x in xs]

    def adopt(self, ext, G, valid):
        """The block's cells of ``ext``, an op's output on a wrap extension
        by ``G`` whose ghosts are exact ``valid`` cells deep (the last
        round of a solve); later ops cut their ghosts of it from ``ext``."""
        block = self.cut(ext, G, WRAP)
        self._ext[id(block)] = (block, valid, self.view(ext, G, valid, WRAP))
        return block

    def cut(self, y, g, mode):
        """The block's cells of an output ``y`` of an op run on the
        extension by ``g`` under ``mode``."""
        for dim, (_, n, _, _) in self.split.items():
            y = y.narrow(dim, self._sides(dim, g, mode)[0], n)
        return y.contiguous()

    # -- ops ----------------------------------------------------------------
    def op(self, fn, depth=None):
        """``fn`` (a key of :data:`HALOS`) on this rank's block: its block
        fields (the tensor arguments of the block's extent) extended by the
        op's halo, its outputs of the extension's extent cut back to the
        block.  ``depth`` overrides the table's (the sweeps of a round)."""
        mode, d, *ghosted = HALOS[fn]
        g = d if depth is None else depth
        if mode == LOCAL or g == 0:
            return fn

        def run(*args, **kw):
            fields = [a for a in (*args, *kw.values()) if self._is_field(a)]
            if not fields:
                raise ValueError(f"{fn.__name__}: no field of the block's extent {self.block}")
            if ghosted:
                named = _signature(fn).bind(*args, **kw).arguments
                keep = {id(named[n]) for n in ghosted[0] if n in named}
                real = [a for a in fields if id(a) in keep]
            else:
                real = fields
            ext = dict(zip(map(id, real), self.extend(real, g, mode)))
            for a in fields:
                if id(a) not in ext:
                    ext[id(a)] = self.pad(a, g, mode)
            args = [ext.get(id(a), a) if self._is_field(a) else a for a in args]
            kw = {k: ext.get(id(v), v) if self._is_field(v) else v for k, v in kw.items()}
            shape = ext[id(fields[0])].shape[2:]
            return _map_out(fn(*args, **kw), lambda y: self.cut(y, g, mode)
                            if isinstance(y, torch.Tensor) and y.shape[2:] == shape else y)

        return run

    def _is_field(self, a):
        return (isinstance(a, torch.Tensor) and a.ndim == 2 + len(self.block)
                and tuple(a.shape[2:]) == self.block)

    def rounds(self, n_iters):
        """The sweeps of each round of an ``n_iters``-sweep solve: one
        exchange of a k-cell halo, then k sweeps on the extended block, k
        an eighth of the block's thinnest split side (at least 1, at most
        ``n_iters``), which keeps the cells a 2D block computes twice under
        a quarter more."""
        thinnest = min((a[1] for a in self.split.values()), default=8 * n_iters)
        k = max(1, min(thinnest // 8, n_iters))
        return [k] * (n_iters // k) + ([n_iters % k] if n_iters % k else [])


def _map_out(value, fn):
    if isinstance(value, (tuple, list)):
        return type(value)(_map_out(v, fn) for v in value)
    return fn(value)


def interior(blk: Blocks, x, dims=None):
    """``x`` (a block field of booleans) where the cell is off the whole
    domain's outermost ring along ``dims`` (default every spatial dim)."""
    for dim in blk.axes if dims is None else dims:
        _, n, c0, N = blk.axes[dim]
        cells = torch.arange(c0, c0 + n, device=x.device)
        shape = [1] * x.ndim
        shape[dim] = n
        x = x & ((cells > 0) & (cells < N - 1)).reshape(shape)
    return x


def any_rank(blk: Blocks, local) -> bool:
    """Whether ``local`` (a tensor of booleans) holds anywhere on any rank
    (one all-reduce; none for a mesh of one rank without a process group,
    as ``make_mesh(slab=True)`` makes it)."""
    if blk.mesh.backend is None:
        return bool(local.any())
    found = torch.tensor([int(local.any())], dtype=torch.int32,
                         device=blk.mesh.device if blk.mesh.backend == "nccl" else "cpu")
    dist.all_reduce(found, op=dist.ReduceOp.MAX)
    return bool(found.item())


def mag_boundary_only(blk: Blocks, magnetic_flags, phys_extent=None) -> bool:
    """``models/ferrofluid.py:_mag_boundary_only`` of the whole domain from
    the ranks' blocks: no magnetic obstacle off the domain's outermost ring
    on any rank; with ``phys_extent`` (a padded layout's box, which starts
    at the domain's first cell) every cell past the box an obstacle and the
    box's interior free of them (one all-reduce)."""
    obs = magnetic_flags == int(CellType.OBSTACLE)
    if phys_extent is None:
        return not any_rank(blk, interior(blk, obs))
    inside = inner = torch.ones_like(obs)
    for dim, p in zip(blk.axes, phys_extent):
        _, n, c0, _ = blk.axes[dim]
        cells = torch.arange(c0, c0 + n, device=obs.device)
        shape = [1] * obs.ndim
        shape[dim] = n
        inside = inside & (cells < p).reshape(shape)
        inner = inner & ((cells > 0) & (cells < p - 1)).reshape(shape)
    return not any_rank(blk, (~inside & ~obs) | (inner & obs))
