"""The port's models: parameters, states, the single-phase, Shan-Chen, HCZ
and ferrofluid steps, scenes, the runner and the step's traffic model."""

from . import traffic
from .ferrofluid import (
    ferrofluid_step,
    init_ferrofluid_state,
    make_H_ext,
    phi_field,
    prime_premac,
)
from .multiphase import hcz_step, init_hcz_state, init_sc_state, sc_step
from .params import SimulationParams
from .runner import SimulationRunner
from .scenes import (
    droplet_spread_2d,
    droplet_spread_3d,
    multiphase_3d,
    multiphase_drop_hcz,
    multiphase_drop_sc,
    rosensweig_2d,
    rosensweig_3d,
    rosensweig_3d_tpu,
    shear_layer,
    two_droplets_2d,
    two_droplets_3d,
    wave,
)
from .singlephase import init_state as init_singlephase_state
from .singlephase import step as singlephase_step
from .state import FerrofluidState, HCZState, SinglePhaseState, from_numpy, to_numpy

__all__ = [
    "SimulationParams",
    "SinglePhaseState",
    "HCZState",
    "FerrofluidState",
    "from_numpy",
    "to_numpy",
    "init_singlephase_state",
    "singlephase_step",
    "init_sc_state",
    "sc_step",
    "init_hcz_state",
    "hcz_step",
    "init_ferrofluid_state",
    "prime_premac",
    "ferrofluid_step",
    "phi_field",
    "make_H_ext",
    "shear_layer",
    "wave",
    "multiphase_drop_sc",
    "multiphase_drop_hcz",
    "droplet_spread_2d",
    "two_droplets_2d",
    "rosensweig_2d",
    "multiphase_3d",
    "droplet_spread_3d",
    "two_droplets_3d",
    "rosensweig_3d",
    "rosensweig_3d_tpu",
    "SimulationRunner",
    "traffic",
]
