"""Cut a state into this rank's part, and put the parts back together.

Port of ``lbm_ferrofluid_tpu/parallel/sharding.py`` (``_leaf_spec``).
Fields are laid out [B, C, (z,) y, x]; the mesh's ``batch`` axis takes the
batch dimension and its spatial axes the array axis counted from the
right, x the last, y the one before and z the one before that, of every
leaf for which that axis is not one of its first two (batch and channels):
a 3D state splits along z, y and x, a 2D state along y and x.
A leaf whose extent along a mesh axis is not divisible by that axis's size
stays whole along it on every rank, as the JAX package replicates it: the
MAC-staggered ``H_ext_mac`` leaves of extent N + 1 along their own axis,
per-step constants.  The grid itself must divide: a state whose f does not
split along a mesh axis raises.  A mesh with a batch axis and a spatial one
cuts both: B / nb elements a rank, each on the rank's block.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from .mesh import Mesh

__all__ = ["shard_state", "gather_state", "SPATIAL_AXES"]

#: array-axis position (from the right) of each spatial mesh axis in the
#: [B, C, (z,) y, x] layout (JAX ``SPATIAL_AXES``)
SPATIAL_AXES = {"x": 1, "y": 2, "z": 3}


def _cut_axes(leaf, mesh: Mesh) -> list:
    """[(array axis, mesh axis name, size, index)] along which ``leaf`` is
    cut: the JAX rule (``_leaf_spec``)."""
    cuts = []
    for name, size in mesh.sizes.items():
        if size == 1 or leaf.ndim == 0:
            continue
        if name == "batch":
            axis = 0
        elif name in SPATIAL_AXES:
            axis = leaf.ndim - SPATIAL_AXES[name]
            if axis < 2:  # scalar/channel axes of low-rank leaves
                continue
        else:
            continue
        if leaf.shape[axis] % size == 0:
            cuts.append((axis, name, size, mesh.coords[name]))
    return cuts


def _map(value, fn):
    if value is None or isinstance(value, (int, float)):
        return value
    if isinstance(value, tuple):
        return tuple(_map(v, fn) for v in value)
    return fn(value)


def shard_state(state, mesh: Mesh):
    """This rank's part of ``state`` (a whole state on any device) on the
    mesh's device: its batch elements (B / nb) and its block of every
    spatial axis that divides (module docstring).  Raises where the grid
    does not split (an axis of f not divisible by its mesh axis, or a
    batch not divisible by nb) and for a z axis of more than one rank on a
    2D state (2D states split along y and x)."""
    B, _, *grid = state.f.shape
    if B % mesh.nb:
        raise ValueError(f"a batch of {B} does not split over the mesh's batch axis of "
                         f"{mesh.nb} ranks: use a batch axis that divides it")
    if len(grid) != 3 and mesh.nz > 1:
        raise NotImplementedError("a z axis of more than one rank splits 3D states only; "
                                  "2D states split along y and x (mesh axes 'y', 'x')")
    for name, n in zip(("z", "y", "x")[3 - len(grid):], grid):
        size = mesh.sizes.get(name, 1)
        if n % size:
            raise ValueError(f"{name.upper()}={n} does not split over the mesh's {name} axis "
                             f"of {size} ranks: use a {name} axis whose size divides it")

    def part(leaf):
        for axis, _, size, idx in _cut_axes(leaf, mesh):
            n = leaf.shape[axis] // size
            leaf = leaf.narrow(axis, idx * n, n)
        return leaf.contiguous().to(mesh.device)

    return dataclasses.replace(state, **{
        fld.name: _map(getattr(state, fld.name), part)
        for fld in dataclasses.fields(state) if fld.name != "step"})


def _all_gather(x, mesh: Mesh, dim: int, ranks):
    """The parts of ``x`` of ``ranks`` (in order), concatenated along
    ``dim``: every rank's part through one ``all_gather`` (staged through
    the host for gloo and CUDA tensors)."""
    staged = x.device.type == "cuda" and mesh.backend == "gloo"
    src = x.contiguous().cpu() if staged else x.contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, src)
    out = torch.cat([parts[r] for r in ranks], dim=dim)
    return out.to(x.device) if staged else out


def gather_state(state, mesh: Mesh):
    """The whole state from every rank's part (the inverse of
    :func:`shard_state`), on every rank, on the mesh's device.  A leaf is
    put together along a spatial mesh axis where its extent there is the
    rank's block's (f's), and along the batch where the mesh has a batch
    axis; leaves that stayed whole are kept.  For tests, checkpoints and
    comparisons: it moves the whole state to every rank."""
    if mesh.nb * mesh.nz * mesh.ny * mesh.nx == 1:
        return state
    f = state.f

    def whole(leaf):
        for name, size in mesh.sizes.items():
            if size == 1 or name not in SPATIAL_AXES or leaf.ndim < 1:
                continue
            axis, f_axis = leaf.ndim - SPATIAL_AXES[name], f.ndim - SPATIAL_AXES[name]
            if axis >= 2 and f_axis >= 2 and leaf.shape[axis] == f.shape[f_axis]:
                leaf = _all_gather(leaf, mesh, axis,
                                   [mesh.rank_at(**{name: i}) for i in range(size)])
        if mesh.nb > 1 and leaf.ndim >= 1:
            leaf = _all_gather(leaf, mesh, 0, [mesh.rank_at(batch=i) for i in range(mesh.nb)])
        return leaf

    return dataclasses.replace(state, **{
        fld.name: _map(getattr(state, fld.name), whole)
        for fld in dataclasses.fields(state) if fld.name != "step"})
