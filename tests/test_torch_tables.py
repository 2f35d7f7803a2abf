"""The port's constant tables and parameters against the JAX package's.

The port keeps its own copies of the lattice tables, the flag enums and
``SimulationParams`` (it imports nothing of the JAX package); these tests
hold the copies equal, and one parameter JSON must load in both packages.
"""

import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import lbm_ferrofluid_tpu.lattice as jlat  # noqa: E402
from lbm_ferrofluid_tpu.models.params import SimulationParams as JParams  # noqa: E402
from lbm_ferrofluid_tpu.utils.types import CellType as JCellType  # noqa: E402
from lbm_ferrofluid_tpu.utils.types import KBCType as JKBCType  # noqa: E402

import lbm_ferrofluid_tpu_torch.lattice as plat  # noqa: E402
from lbm_ferrofluid_tpu_torch.models.params import SimulationParams as PParams  # noqa: E402
from lbm_ferrofluid_tpu_torch.utils.types import CellType, KBCType  # noqa: E402


@pytest.mark.parametrize("name", ["D2Q9", "D3Q19"])
def test_lattice_tables_equal_exactly(name):
    a, b = getattr(plat, name), getattr(jlat, name)
    assert (a.name, a.dim, a.q) == (b.name, b.dim, b.q)
    # exact float64 equality: the f32 rounding happens at the point of use
    np.testing.assert_array_equal(a.weights, b.weights)
    assert a.weights.dtype == np.float64
    np.testing.assert_array_equal(a.e, b.e)
    np.testing.assert_array_equal(a.opposite, b.opposite)
    assert a.shifts() == b.shifts()
    np.testing.assert_array_equal(a.w_bcast(np.float32), b.w_bcast(np.float32))


@pytest.mark.parametrize("enum_pair", [(CellType, JCellType), (KBCType, JKBCType)])
def test_enums_equal(enum_pair):
    port, jax_enum = enum_pair
    assert {m.name: int(m) for m in port} == {m.name: int(m) for m in jax_enum}


def test_params_fields_and_defaults_equal():
    pf = [(f.name, f.default) for f in dataclasses.fields(PParams)]
    jf = [(f.name, f.default) for f in dataclasses.fields(JParams)]
    assert pf == jf


_CONFIGS = [
    {},
    dict(dim=3, kappa=0.01, tau_f=0.68, tau_g=0.68, gravity=1e-4,
         contact_angle=0.5 * math.pi, mag_strength=85.0, poisson_iters=30,
         mag_flags_shell=True, density_gas=0.02381, density_fluid=0.2508,
         rho_gas=0.02381, rho_fluid=0.2508),
    dict(dim=3, gravity_axis=2, h_ext_axis=2, phys_extent=(66, 130, 130),
         fg_dtype="bfloat16", h_dtype="bfloat16", kbc_type=int(JKBCType.KBC_A)),
]


@pytest.mark.parametrize("cfg", _CONFIGS)
def test_params_json_round_trips_between_packages(cfg):
    jp = JParams(**cfg)
    pp = PParams.from_json(jp.to_json())
    assert pp.to_json() == jp.to_json()
    assert JParams.from_json(pp.to_json()) == jp
    assert dataclasses.asdict(pp) == dataclasses.asdict(jp)
    np.testing.assert_array_equal(pp.gravity_vec(), jp.gravity_vec())
    assert (pp.c, pp.cs2, pp.Q) == (jp.c, jp.cs2, jp.Q)
