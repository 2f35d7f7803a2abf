"""PyTorch/CUDA port of lbm_ferrofluid_tpu for one NVIDIA H100.

The JAX package ``lbm_ferrofluid_tpu`` is the reference this package is held
against; this package imports nothing of it and no JAX.  Layout mirrors it:
``lattice``, ``utils``, ``ops`` (plain PyTorch operators), ``ops/kernels``
(the hand-written Hopper kernels, counterpart of ``ops/pallas``), ``csrc``
(their CUDA sources) and ``models``.

Quick start (on the card)::

    from lbm_ferrofluid_tpu_torch.models import (
        SimulationRunner, ferrofluid_step, hcz_step, multiphase_3d, rosensweig_3d,
    )
    params, state = rosensweig_3d()            # 130x66x130, device="cuda"
    state = SimulationRunner(params, ferrofluid_step).run(state, 100)
    params, state = multiphase_3d()            # 130^3 HCZ cube drop
    state = SimulationRunner(params, hcz_step).run(state, 100)

Pass ``device="cpu"`` to every entry point to run the plain PyTorch versions
on the CPU; without a GPU the default raises.
"""

from . import lattice, models, ops
from .lattice import D2Q9, D3Q19, Lattice, get_lattice
from .utils.types import CellType, KBCType

__all__ = [
    "lattice",
    "models",
    "ops",
    "Lattice",
    "D2Q9",
    "D3Q19",
    "get_lattice",
    "CellType",
    "KBCType",
]
