"""The ferrofluid model of the port: parameters, state, step, scenes, runner."""

from .ferrofluid import (
    ferrofluid_step,
    init_ferrofluid_state,
    make_H_ext,
    phi_field,
    prime_premac,
)
from .params import SimulationParams
from .runner import SimulationRunner
from .scenes import rosensweig_3d
from .state import FerrofluidState, from_numpy, to_numpy

__all__ = [
    "SimulationParams",
    "FerrofluidState",
    "from_numpy",
    "to_numpy",
    "init_ferrofluid_state",
    "prime_premac",
    "ferrofluid_step",
    "phi_field",
    "make_H_ext",
    "rosensweig_3d",
    "SimulationRunner",
]
