"""The port's models: parameters, states, the HCZ and ferrofluid steps,
scenes and the runner."""

from .ferrofluid import (
    ferrofluid_step,
    init_ferrofluid_state,
    make_H_ext,
    phi_field,
    prime_premac,
)
from .multiphase import hcz_step, init_hcz_state
from .params import SimulationParams
from .runner import SimulationRunner
from .scenes import droplet_spread_3d, multiphase_3d, rosensweig_3d, two_droplets_3d
from .state import FerrofluidState, HCZState, from_numpy, to_numpy

__all__ = [
    "SimulationParams",
    "HCZState",
    "FerrofluidState",
    "from_numpy",
    "to_numpy",
    "init_hcz_state",
    "hcz_step",
    "init_ferrofluid_state",
    "prime_premac",
    "ferrofluid_step",
    "phi_field",
    "make_H_ext",
    "multiphase_3d",
    "droplet_spread_3d",
    "two_droplets_3d",
    "rosensweig_3d",
    "SimulationRunner",
]
