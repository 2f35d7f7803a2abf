"""Rank meshes for the decomposition of a state over ranks.

Port of ``lbm_ferrofluid_tpu/parallel/mesh.py``.  The JAX package lays a
``jax.sharding.Mesh`` over devices; here every rank is one process with
one device, joined by ``torch.distributed``, and :class:`Mesh` is this
rank's view of the ranks: its coordinates along the named axes, its device
and the backend its exchanges use.  The axes are ``batch`` (data parallel:
a batch element a rank), and ``z``, ``y`` and ``x``, the spatial axes: a
3D grid splits along any of them (z-slabs on the slab forms, or blocks,
``parallel/step3d.py``), a 2D grid along y and x (``parallel/step2d.py``).

The transport is chosen, never found by trying: NCCL where every rank of a
host has a card of its own, gloo otherwise (the CPU, and several ranks that
share one card, which NCCL refuses; ``parallel/halo.py`` stages CUDA
tensors through pinned host buffers for gloo).
"""

from __future__ import annotations

import dataclasses
import math
import os

import torch
import torch.distributed as dist

__all__ = ["Mesh", "make_mesh", "auto_mesh_shape", "initialize_distributed", "AXES"]

#: the mesh axes that may be larger than 1
AXES = ("batch", "z", "y", "x")

#: this process's rank on its host, as :func:`initialize_distributed` read it
_local_rank: int | None = None


def default_backend(local_world_size: int) -> str:
    """NCCL when CUDA is there and each of the host's ``local_world_size``
    ranks has a card of its own; gloo otherwise."""
    if torch.cuda.is_available() and local_world_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    local_rank: int | None = None,
    backend: str | None = None,
) -> int:
    """Join the process group and return the number of processes.

    Reads torchrun's variables where an argument is not given:
    ``MASTER_ADDR`` and ``MASTER_PORT`` (the coordinator, ``host:port``),
    ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE``.  With
    none of them set and no argument it returns 1 and initializes nothing
    (a single-process run), as the JAX package's does.  ``backend`` None
    takes :func:`default_backend`.  An initialized group returns its size.
    """
    global _local_rank
    if dist.is_initialized():
        return dist.get_world_size()
    env = os.environ
    if coordinator_address is None and env.get("MASTER_ADDR") and env.get("MASTER_PORT"):
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None and env.get("WORLD_SIZE"):
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and env.get("RANK"):
        process_id = int(env["RANK"])
    if local_rank is None and env.get("LOCAL_RANK"):
        local_rank = int(env["LOCAL_RANK"])
    if coordinator_address is None and num_processes is None and process_id is None:
        return 1
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError(
            "initialize_distributed needs the coordinator address, the number of processes "
            "and this process's id (or torchrun's MASTER_ADDR/MASTER_PORT, WORLD_SIZE, RANK)"
        )
    _local_rank = process_id if local_rank is None else local_rank
    if backend is None:
        backend = default_backend(int(env.get("LOCAL_WORLD_SIZE", num_processes)))
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    return num_processes


def auto_mesh_shape(n_devices: int, n_axes: int = 2) -> tuple[int, ...]:
    """Factor ``n_devices`` into a near-balanced ``n_axes``-tuple, smaller
    factors first: 8 -> (2, 4) for 2 axes, (2, 2, 2) for 3 (the JAX
    package's)."""
    shape = [1] * n_axes
    remaining = n_devices
    i = 0
    while remaining > 1:
        p = next(p for p in range(2, remaining + 1) if remaining % p == 0)
        shape[i % n_axes] *= p
        remaining //= p
        i += 1
    return tuple(sorted(shape))


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place among the ranks: ``shape`` over ``axis_names``
    (row-major in the rank, as the JAX package lays devices), its
    ``device``, the ``backend`` of its exchanges (None for one rank
    without a process group), ``slab``, which keeps the slab forms running
    at ``nz == 1`` (ghosts from the rank itself: the JAX package's
    ``LBM_SLAB_FORCE``)."""

    axis_names: tuple
    shape: tuple
    rank: int
    device: torch.device
    backend: str | None = None
    slab: bool = False

    @property
    def sizes(self) -> dict:
        return dict(zip(self.axis_names, self.shape))

    @property
    def coords(self) -> dict:
        idx, rest = {}, self.rank
        for name, size in reversed(tuple(zip(self.axis_names, self.shape))):
            idx[name] = rest % size
            rest //= size
        return {name: idx[name] for name in self.axis_names}

    @property
    def nb(self) -> int:
        return self.sizes.get("batch", 1)

    @property
    def nz(self) -> int:
        return self.sizes.get("z", 1)

    @property
    def ny(self) -> int:
        return self.sizes.get("y", 1)

    @property
    def nx(self) -> int:
        return self.sizes.get("x", 1)

    @property
    def ib(self) -> int:
        return self.coords.get("batch", 0)

    @property
    def iz(self) -> int:
        return self.coords.get("z", 0)

    @property
    def iy(self) -> int:
        return self.coords.get("y", 0)

    @property
    def ix(self) -> int:
        return self.coords.get("x", 0)

    def rank_at(self, **coords) -> int:
        """The rank at this rank's coordinates with ``coords`` in their
        place (each taken modulo its axis's size)."""
        idx = dict(self.coords, **coords)
        rank = 0
        for name, size in zip(self.axis_names, self.shape):
            rank = rank * size + idx.get(name, 0) % size
        return rank

    def z_rank(self, iz: int) -> int:
        """The rank with this rank's coordinates but ``iz`` mod nz along z."""
        return self.rank_at(z=iz)


def make_mesh(axis_names: tuple = ("z", "y"), shape: tuple | None = None, *,
              backend: str | None = None, device=None, slab: bool = False) -> Mesh:
    """This rank's :class:`Mesh` over the process group's ranks (one rank
    without a group).

    ``axis_names`` defaults to the JAX package's ("z", "y"); ``shape=None``
    factors the ranks over the axes (:func:`auto_mesh_shape`).
    ``device``: ``"cpu"``, or None for ``cuda:<local rank mod the card
    count>``, which becomes the current card (a CUDA device is required
    then).  ``backend`` names the exchanges' transport, by default the
    group's.  ``slab=True`` runs the slab forms at ``nz == 1`` too (their
    ghosts from the rank itself: sent to itself through NCCL, else
    copied, :func:`~.halo.ring_halo`).  Raises where ``shape`` does not cover the ranks
    or names an axis other than ``batch``, ``z``, ``y`` and ``x`` larger than 1."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    axis_names = tuple(axis_names)
    shape = auto_mesh_shape(world, len(axis_names)) if shape is None else tuple(shape)
    wide = [f"{n}={s}" for n, s in zip(axis_names, shape) if s > 1 and n not in AXES]
    if wide:
        raise ValueError(f"mesh axes {', '.join(wide)}: the port's mesh axes are "
                         f"{', '.join(AXES)}")
    if len(shape) != len(axis_names) or math.prod(shape) != world:
        raise ValueError(f"mesh shape {shape} over axes {axis_names} does not cover "
                         f"{world} ranks")
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device; pass device='cpu' to run the ranks "
                               "on the CPU")
        local = rank if _local_rank is None else _local_rank
        device = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(device)
    device = torch.device(device)
    if dist.is_initialized() and backend is None:
        backend = dist.get_backend()
    return Mesh(axis_names, shape, rank, device, backend, bool(slab))
