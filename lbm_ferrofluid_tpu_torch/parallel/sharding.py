"""Cut a state into this rank's part, and put the parts back together.

Port of ``lbm_ferrofluid_tpu/parallel/sharding.py``.  Fields are laid out
[B, C, (z,) y, x]; the mesh's ``batch`` axis takes the batch dimension and
its ``z`` axis the z dimension of every leaf of rank 5.  A leaf whose
extent along a mesh axis is not divisible by that axis's size stays whole
on every rank, as the JAX package replicates it: the MAC-staggered
``H_ext_mac`` leaf of extent Z + 1 along z, a per-step constant.  The grid
itself must divide: a state whose f does not split along z raises.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from .mesh import Mesh

__all__ = ["shard_state", "gather_state"]


def _split(leaf, mesh: Mesh):
    """(batch axis split?, z axis split?) for a tensor leaf."""
    by_b = mesh.nb > 1 and leaf.ndim >= 1 and leaf.shape[0] % mesh.nb == 0
    by_z = mesh.nz > 1 and leaf.ndim == 5 and leaf.shape[2] % mesh.nz == 0
    return by_b, by_z


def _map(value, fn):
    if value is None or isinstance(value, (int, float)):
        return value
    if isinstance(value, tuple):
        return tuple(_map(v, fn) for v in value)
    return fn(value)


def shard_state(state, mesh: Mesh):
    """This rank's part of ``state`` (a whole state on any device) on the
    mesh's device: its batch element (of B / nb) and z-slab (of Z / nz) of
    every leaf that divides (module docstring).  Raises where the grid does
    not split: Z not divisible by nz, or a batch not divisible by nb."""
    B, _, *grid = state.f.shape
    if B % mesh.nb:
        raise ValueError(f"a batch of {B} does not split over the mesh's batch axis of "
                         f"{mesh.nb} ranks: use a batch axis that divides it")
    if len(grid) != 3 and mesh.nz > 1:
        raise NotImplementedError("a z axis of more than one rank decomposes 3D states only; "
                                  "the 2D paths are not decomposed (ROADMAP A12)")
    if mesh.nz > 1 and grid[0] % mesh.nz:
        raise ValueError(f"Z={grid[0]} does not split over the mesh's z axis of {mesh.nz} ranks: "
                         "use a z axis whose size divides Z")

    def part(leaf):
        by_b, by_z = _split(leaf, mesh)
        if by_b:
            n = leaf.shape[0] // mesh.nb
            leaf = leaf[mesh.ib * n:(mesh.ib + 1) * n]
        if by_z:
            n = leaf.shape[2] // mesh.nz
            leaf = leaf[:, :, mesh.iz * n:(mesh.iz + 1) * n]
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
    put together along z where its z extent is the slab's (f's) and along
    the batch where the mesh has a batch axis; leaves that stayed whole
    are kept.  For tests, checkpoints and comparisons: it moves the whole
    state to every rank."""
    if mesh.nb * mesh.nz == 1:
        return state
    Zl = state.f.shape[2] if state.f.ndim == 5 else None
    z_ranks = [mesh.rank_at(z=i) for i in range(mesh.nz)]
    b_ranks = [mesh.rank_at(batch=i) for i in range(mesh.nb)]

    def whole(leaf):
        if mesh.nz > 1 and leaf.ndim == 5 and leaf.shape[2] == Zl:
            leaf = _all_gather(leaf, mesh, 2, z_ranks)
        if mesh.nb > 1 and leaf.ndim >= 1:
            leaf = _all_gather(leaf, mesh, 0, b_ranks)
        return leaf

    return dataclasses.replace(state, **{
        fld.name: _map(getattr(state, fld.name), whole)
        for fld in dataclasses.fields(state) if fld.name != "step"})
