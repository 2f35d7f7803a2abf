"""Rank meshes, halo exchange and the z-slab decomposition of the ferrofluid
steady state over ranks (counterpart of ``lbm_ferrofluid_tpu/parallel/``)."""

from .halo import ring_halo, sharded_poisson_sweeps
from .mesh import Mesh, auto_mesh_shape, initialize_distributed, make_mesh
from .sharding import gather_state, shard_state

__all__ = [
    "Mesh",
    "auto_mesh_shape",
    "initialize_distributed",
    "make_mesh",
    "ring_halo",
    "sharded_poisson_sweeps",
    "shard_state",
    "gather_state",
]
