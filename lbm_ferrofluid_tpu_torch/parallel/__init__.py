"""Rank meshes, halo exchange, the decomposition of the 3D steps over
ranks into z-slabs on the kernels' slab forms or (z, y, x) blocks on the
single-device kernels (``step3d``), and of the 2D steps into y/x blocks
(``step2d``), both through ``blocks.Blocks`` (counterpart of
``lbm_ferrofluid_tpu/parallel/``)."""

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
