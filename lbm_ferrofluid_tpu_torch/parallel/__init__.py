"""Rank meshes, halo exchange, the z-slab decomposition of the 3D steps
(``step3d``) and the y/x decomposition of the 2D steps (``step2d``) over
ranks (counterpart of ``lbm_ferrofluid_tpu/parallel/``)."""

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
