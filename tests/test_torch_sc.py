"""The port's Shan-Chen model against the JAX package.

* ``macro_moments``, ``sc_force`` (2D and 3D: zero padding outside the
  domain, the wall's psi on obstacles) and ``sc_collide`` against their JAX
  twins in float64, inputs from a numpy seed: rel <= 1e-12, the same
  arithmetic in the same order;
* ``multiphase_drop_sc`` gives the JAX builder's params and arrays, with
  ``g`` and ``pressure`` None;
* 3 port steps (float32, CPU) against 3 JAX ``sc_step`` steps at rel <=
  2e-5 (the bar of tests/test_torch_ferrofluid.py);
* ``tests/golden/sc.npz`` (reference solver, 20 steps) at the bars of
  tests/test_parity.py;
* a JAX Shan-Chen ``HCZState`` given to ``from_numpy`` steps as the JAX
  one and round-trips, its None leaves included.
"""

import dataclasses
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lbm_ferrofluid_tpu import models as jmodels  # noqa: E402
from lbm_ferrofluid_tpu.lattice import D2Q9 as JD2Q9  # noqa: E402
from lbm_ferrofluid_tpu.lattice import D3Q19 as JD3Q19  # noqa: E402
from lbm_ferrofluid_tpu.models import scenes as jscenes  # noqa: E402
from lbm_ferrofluid_tpu.ops import collide as jcollide  # noqa: E402
from lbm_ferrofluid_tpu.ops import moments as jmoments  # noqa: E402

from lbm_ferrofluid_tpu_torch.lattice import D2Q9, D3Q19  # noqa: E402
from lbm_ferrofluid_tpu_torch.models import (  # noqa: E402
    HCZState,
    SimulationParams,
    SimulationRunner,
    from_numpy,
    init_sc_state,
    multiphase_drop_sc,
    sc_step,
    to_numpy,
)
from lbm_ferrofluid_tpu_torch.ops import collide as pcollide  # noqa: E402
from lbm_ferrofluid_tpu_torch.ops import kernels  # noqa: E402
from lbm_ferrofluid_tpu_torch.ops import moments as pmoments  # noqa: E402

GOLDEN = pathlib.Path(__file__).parent / "golden"
OBS, FLUID = 2, 1
RG, RF = 0.02381, 0.2508
LATS = {2: (JD2Q9, D2Q9, (24, 20)), 3: (JD3Q19, D3Q19, (6, 8, 10))}


def rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def T(x):
    return torch.from_numpy(np.array(x))


def _jax_fields(state):
    def conv(v):
        if v is None:
            return None
        if isinstance(v, tuple):
            return tuple(conv(x) for x in v)
        return np.asarray(v)
    return {f.name: conv(getattr(state, f.name)) for f in dataclasses.fields(state)}


def _fields(dim, seed):
    """Seeded float64 fields: an obstacle frame plus one interior obstacle
    cell, densities across the two phases, f near equilibrium."""
    jlat, _, res = LATS[dim]
    rng = np.random.default_rng(seed)
    fl = np.full((1, 1, *res), OBS, np.uint8)
    fl[(Ellipsis,) + (slice(1, -1),) * dim] = FLUID
    fl[(Ellipsis,) + tuple(n // 2 for n in res)] = OBS
    den = RG + (RF - RG) * rng.uniform(0.0, 1.0, (1, 1, *res))
    w = jlat.w_bcast(np.float64)
    return dict(flags=fl, den=den, rho=rng.uniform(0.02, 0.26, (1, 1, *res)),
                vel=rng.uniform(-0.02, 0.02, (1, dim, *res)),
                f=w * den * (1.0 + 0.05 * rng.standard_normal((1, jlat.q, *res))))


@pytest.mark.parametrize("dim", [2, 3])
def test_macro_moments_match_jax(dim):
    d = _fields(dim, 1)
    jlat, plat, _ = LATS[dim]
    want = jmoments.macro_moments(jlat, jnp.asarray(d["f"]), jnp.asarray(d["rho"]),
                                  jnp.asarray(d["vel"]), jnp.asarray(d["flags"]))
    got = pmoments.macro_moments(plat, T(d["f"]), T(d["rho"]), T(d["vel"]), T(d["flags"]))
    for name, a, b in zip(("rho", "vel"), got, want, strict=True):
        assert rel(a, b) <= 1e-12, name


@pytest.mark.parametrize("dim", [2, 3])
def test_sc_force_matches_jax(dim):
    d = _fields(dim, 2)
    jlat, plat, _ = LATS[dim]
    wall = 0.5 * (RG + RF)
    want = jcollide.sc_force(jlat, jnp.asarray(d["den"]), jnp.asarray(d["flags"]),
                             density_wall=wall)
    got = pcollide.sc_force(plat, T(d["den"]), T(d["flags"]), density_wall=wall)
    assert rel(got, want) <= 1e-12
    assert float(got.abs().max()) > 0.0


def test_sc_collide_matches_jax():
    d = _fields(2, 3)
    args = (d["f"], d["rho"], d["den"], d["vel"], d["flags"])
    kw = dict(tau=1.0, density_wall=0.5 * (RG + RF))
    want = jcollide.sc_collide(JD2Q9, *(jnp.asarray(a) for a in args), **kw)
    got = pcollide.sc_collide(D2Q9, *(T(a) for a in args), **kw)
    for name, a, b in zip(("f", "force"), got, want, strict=True):
        assert rel(a, b) <= 1e-12, name


def test_scene_matches_jax():
    jp, js = jscenes.multiphase_drop_sc(res=(16, 20))
    pp, ps = multiphase_drop_sc(res=(16, 20), device="cpu")
    assert pp.to_json() == jp.to_json()
    assert isinstance(ps, HCZState) and ps.g is None and ps.pressure is None
    assert rel(ps.f, js.f) <= 1e-6
    for name in ("rho", "vel", "density", "force", "flags"):
        np.testing.assert_array_equal(getattr(ps, name).numpy(), np.asarray(getattr(js, name)))


def _steps(jp, js, n):
    pp = SimulationParams.from_json(jp.to_json())
    ps = from_numpy(_jax_fields(js), device="cpu")
    start = ps.step
    for _ in range(n):
        js = jmodels.sc_step(jp, js)
        ps = sc_step(pp, ps, device="cpu")
    assert ps.step == int(js.step) == start + n
    return ps, js


def test_three_steps_match_jax_step():
    ps, js = _steps(*jscenes.multiphase_drop_sc(res=(16, 20)), 3)
    for fld in ("f", "rho", "vel", "density", "force"):
        r = rel(getattr(ps, fld), getattr(js, fld))
        assert r <= 2e-5, f"{fld}: max rel dev {r:.2e}"
    assert ps.g is None and ps.pressure is None


def _assert_close(got, want, name, atol=2e-5, rtol=2e-4):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    err = np.abs(got - want).max()
    scale = np.abs(want).max() + 1e-30
    assert err <= atol + rtol * scale, f"{name}: max|err|={err:.3e} scale={scale:.3e}"


def test_golden_sc():
    """tests/test_parity.py:test_sc_parity through the port."""
    d = np.load(GOLDEN / "sc.npz")
    res = d["rho0"].shape[2:]
    params = SimulationParams(dim=2, tau=1.0, density_gas=RG, density_fluid=RF, rho_gas=RG,
                              rho_fluid=RF)
    state = init_sc_state(params, d["rho0"], d["den0"], np.zeros((1, 2, *res), np.float32),
                          d["flags"], device="cpu")
    _assert_close(state.f, d["f0"], "f_init", atol=1e-6)
    state = SimulationRunner(params, sc_step, device="cpu").run(state, 20)
    for name, key in (("f", "f"), ("rho", "rho"), ("vel", "vel"), ("density", "den")):
        _assert_close(getattr(state, name), d[key], name)


def test_jax_state_carried_across_steps_as_jax():
    jp, js = jscenes.multiphase_drop_sc(res=(16, 20))
    for _ in range(2):
        js = jmodels.sc_step(jp, js)
    fields = _jax_fields(js)
    ps = from_numpy(fields, device="cpu")
    assert isinstance(ps, HCZState) and ps.step == 2 and ps.g is None
    back = to_numpy(ps)
    assert set(back) == set(fields)
    for k, v in fields.items():
        if v is None:
            assert back[k] is None, k
        else:
            np.testing.assert_array_equal(back[k], v, err_msg=k)
    ps, js = _steps(jp, js, 1)
    for fld in ("f", "rho", "vel", "density", "force"):
        assert rel(getattr(ps, fld), getattr(js, fld)) <= 2e-5, fld


def test_cpu_runs_leave_launch_counters_at_zero():
    kernels.reset_launch_counts()
    params, state = multiphase_drop_sc(res=(10, 12), device="cpu")
    state = SimulationRunner(params, sc_step, device="cpu").run(state, 2, check_every=1)
    assert state.step == 2
    assert all(v == 0 for v in kernels.launch_counts().values())
