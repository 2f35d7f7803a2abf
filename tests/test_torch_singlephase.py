"""The port's single-phase model (BGK and KBC) against the JAX package.

* ``bgk_collide``, ``kbc_moment_split`` (KBC A-D and the LBGK id) and
  ``kbc_collide`` (KBC A-D) against their JAX twins in float64, inputs
  from a numpy seed: rel <= 1e-12, the same arithmetic in the same order;
  ``kbc_collide`` also on cells where f == feq, which the γ guard sends to
  LBGK (the reference divides 0/0 there);
* ``shear_layer`` (BGK and KBC_A) gives the JAX builder's params and
  arrays;
* 3 port steps (float32, CPU) against 3 JAX ``singlephase_step`` steps at
  rel <= 2e-5 (the bar of tests/test_torch_ferrofluid.py): 2D BGK and KBC
  on ``shear_layer``, and 3D D3Q19 BGK on a seeded Taylor-Green-like field
  with an obstacle frame, whose stream is B8a's plain version on the CPU;
* ``tests/golden/singlephase_{bgk,kbc_a}.npz`` (reference solver, 20
  steps) at the bars of tests/test_parity.py;
* a JAX ``SinglePhaseState`` given to ``from_numpy`` steps as the JAX one
  and round-trips; the runner drives the step; KBC on a D3Q19 state raises
  the JAX package's ``ValueError``; the CPU launches no kernel.
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
from lbm_ferrofluid_tpu.ops.equilibrium import feq as jfeq  # noqa: E402

from lbm_ferrofluid_tpu_torch.lattice import D2Q9, D3Q19  # noqa: E402
from lbm_ferrofluid_tpu_torch.models import (  # noqa: E402
    SimulationParams,
    SimulationRunner,
    SinglePhaseState,
    from_numpy,
    init_singlephase_state,
    shear_layer,
    singlephase_step,
    to_numpy,
)
from lbm_ferrofluid_tpu_torch.ops import collide as pcollide  # noqa: E402
from lbm_ferrofluid_tpu_torch.ops import kernels  # noqa: E402

GOLDEN = pathlib.Path(__file__).parent / "golden"
OBS, FLUID = 2, 1
KBC = {"A": 0b10000101, "B": 0b10000110, "C": 0b10001001, "D": 0b10001010}
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
    cell, f near its equilibrium, a small body force."""
    jlat, _, res = LATS[dim]
    rng = np.random.default_rng(seed)
    fl = np.full((1, 1, *res), OBS, np.uint8)
    fl[(Ellipsis,) + (slice(1, -1),) * dim] = FLUID
    fl[(Ellipsis,) + tuple(n // 2 for n in res)] = OBS
    rho = rng.uniform(0.9, 1.1, (1, 1, *res))
    vel = rng.uniform(-0.05, 0.05, (1, dim, *res))
    w = jlat.w_bcast(np.float64)
    return dict(flags=fl, rho=rho, vel=vel,
                f=w * rho * (1.0 + 0.05 * rng.standard_normal((1, jlat.q, *res))),
                force=rng.uniform(-1e-4, 1e-4, (1, dim, *res)))


# ---------------------------------------------------------------- ops, float64
@pytest.mark.parametrize("forced", [False, True], ids=["no_force", "force"])
@pytest.mark.parametrize("dim", [2, 3])
def test_bgk_collide_matches_jax(dim, forced):
    d = _fields(dim, 1)
    jlat, plat, _ = LATS[dim]
    force = d["force"] if forced else None
    want = jcollide.bgk_collide(
        jlat, jnp.asarray(d["f"]), jnp.asarray(d["rho"]), jnp.asarray(d["vel"]),
        jnp.asarray(d["flags"]), None if force is None else jnp.asarray(force), tau=0.8)
    got = pcollide.bgk_collide(plat, T(d["f"]), T(d["rho"]), T(d["vel"]), T(d["flags"]),
                               None if force is None else T(force), tau=0.8)
    assert rel(got, want) <= 1e-12


@pytest.mark.parametrize("variant", ["A", "B", "C", "D", "LBGK"])
def test_kbc_moment_split_matches_jax(variant):
    d = _fields(2, 2)
    kbc = KBC.get(variant, 0)
    want = jcollide.kbc_moment_split(JD2Q9, jnp.asarray(d["f"]), jnp.asarray(d["rho"]),
                                     jnp.asarray(d["vel"]), kbc, dx=1.0, dt=1.0)
    got = pcollide.kbc_moment_split(D2Q9, T(d["f"]), T(d["rho"]), T(d["vel"]), kbc)
    assert rel(got, want) <= 1e-12


@pytest.mark.parametrize("variant", ["A", "B", "C", "D"])
def test_kbc_collide_matches_jax(variant):
    """Each cell of the left half has f == feq, where the estimator's
    denominator vanishes and the guard takes gamma = 2 (LBGK); the rest
    relax through the reference formula."""
    d = _fields(2, 3)
    f_eq = np.asarray(jfeq(JD2Q9, jnp.asarray(d["rho"]), jnp.asarray(d["vel"]), tau=0.7,
                           force=jnp.asarray(d["force"])))
    f = d["f"].copy()
    f[..., :10] = f_eq[..., :10]
    args = (f, d["rho"], d["vel"], d["flags"], d["force"])
    want = jcollide.kbc_collide(JD2Q9, *(jnp.asarray(a) for a in args), tau=0.7,
                                kbc_type=KBC[variant])
    got = pcollide.kbc_collide(D2Q9, *(T(a) for a in args), tau=0.7, kbc_type=KBC[variant])
    assert rel(got, want) <= 1e-12
    assert bool(torch.isfinite(got).all())


def test_kbc_moment_split_refuses_d3q19():
    d = _fields(3, 4)
    with pytest.raises(ValueError, match="D2Q9 only"):
        pcollide.kbc_moment_split(D3Q19, T(d["f"]), T(d["rho"]), T(d["vel"]), KBC["A"])


# ---------------------------------------------------------------- scenes and steps
@pytest.mark.parametrize("kbc", [False, True], ids=["bgk", "kbc_a"])
def test_shear_layer_matches_jax(kbc):
    jp, js = jscenes.shear_layer(res=(16, 20), kbc=kbc)
    pp, ps = shear_layer(res=(16, 20), kbc=kbc, device="cpu")
    assert pp.to_json() == jp.to_json()
    assert isinstance(ps, SinglePhaseState)
    assert rel(ps.f, js.f) <= 1e-6
    for name in ("rho", "vel", "force", "flags"):
        np.testing.assert_array_equal(getattr(ps, name).numpy(), np.asarray(getattr(js, name)))


def _steps(jp, js, n):
    """``n`` JAX steps and ``n`` port steps from the same state, carried
    across as numpy arrays."""
    pp = SimulationParams.from_json(jp.to_json())
    ps = from_numpy(_jax_fields(js), device="cpu")
    for _ in range(n):
        js = jmodels.singlephase_step(jp, js)
        ps = singlephase_step(pp, ps, device="cpu")
    assert ps.step == int(js.step) == n
    return ps, js


@pytest.mark.parametrize("kbc", [False, True], ids=["bgk", "kbc_a"])
def test_three_2d_steps_match_jax_step(kbc):
    ps, js = _steps(*jscenes.shear_layer(res=(16, 20), kbc=kbc), 3)
    for fld in ("f", "rho", "vel"):
        r = rel(getattr(ps, fld), getattr(js, fld))
        assert r <= 2e-5, f"{fld}: max rel dev {r:.2e}"


def taylor_green_3d(res, *, tau=0.8, u0=0.05, seed=0, device=None):
    """D3Q19 single-phase BGK on a Taylor-Green-like field: rho 1, |u| <=
    ``u0`` (a seeded phase per axis), FLUID inside an obstacle frame."""
    rng = np.random.default_rng(seed)
    Z, Y, X = res
    z, y, x = np.meshgrid(*(2 * np.pi * (np.arange(n) + 0.5) / n for n in res), indexing="ij")
    a, b, c = rng.uniform(0.0, 2 * np.pi, 3)
    vel = np.zeros((1, 3, Z, Y, X), np.float32)
    vel[0, 0] = np.sin(x + a) * np.cos(y + b) * np.cos(z + c)
    vel[0, 1] = -np.cos(x + a) * np.sin(y + b) * np.cos(z + c)
    vel *= u0 / np.sqrt(2.0)
    flags = np.full((1, 1, *res), OBS, np.uint8)
    flags[..., 1:-1, 1:-1, 1:-1] = FLUID
    vel[:, :, flags[0, 0] == OBS] = 0.0
    params = SimulationParams(dim=3, tau=tau)
    rho = np.ones((1, 1, *res), np.float32)
    return params, rho, vel, flags


def test_three_3d_bgk_steps_match_jax_step():
    params, rho, vel, flags = taylor_green_3d((8, 10, 12))
    assert np.abs(vel).max() <= 0.05
    js = jmodels.init_singlephase_state(params, rho, vel, flags)
    ps, js = _steps(params, js, 3)
    for fld in ("f", "rho", "vel"):
        r = rel(getattr(ps, fld), getattr(js, fld))
        assert r <= 2e-5, f"{fld}: max rel dev {r:.2e}"


@pytest.mark.parametrize("variant", ["bgk", "kbc_a"])
def test_golden_singlephase(variant):
    """tests/test_parity.py:test_singlephase_parity through the port."""
    d = np.load(GOLDEN / f"singlephase_{variant}.npz")
    res = d["f0"].shape[2:]
    params = SimulationParams(dim=2, tau=float(d["tau"]),
                              kbc_type=KBC["A"] if variant == "kbc_a" else None)
    flags = np.full((1, 1, *res), FLUID, np.uint8)
    rho = np.full((1, 1, *res), 0.265, np.float32)
    state = init_singlephase_state(params, rho, d["vel0"].astype(np.float32), flags,
                                   device="cpu")
    _assert_close(state.f, d["f0"], "f_init", atol=1e-6)
    state = SimulationRunner(params, singlephase_step, device="cpu").run(state, 20)
    for name in ("f", "rho", "vel"):
        _assert_close(getattr(state, name), d[name], name)


def _assert_close(got, want, name, atol=2e-5, rtol=2e-4):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    err = np.abs(got - want).max()
    scale = np.abs(want).max() + 1e-30
    assert err <= atol + rtol * scale, f"{name}: max|err|={err:.3e} scale={scale:.3e}"


def test_jax_state_carried_across_steps_as_jax():
    jp, js = jscenes.shear_layer(res=(16, 20), kbc=True)
    for _ in range(2):
        js = jmodels.singlephase_step(jp, js)
    fields = _jax_fields(js)
    ps = from_numpy(fields, device="cpu")
    assert isinstance(ps, SinglePhaseState) and ps.step == 2
    back = to_numpy(ps)
    assert set(back) == set(fields)
    for k, v in fields.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    ps = singlephase_step(SimulationParams.from_json(jp.to_json()), ps, device="cpu")
    js = jmodels.singlephase_step(jp, js)
    for fld in ("f", "rho", "vel"):
        assert rel(getattr(ps, fld), getattr(js, fld)) <= 2e-5, fld


def test_kbc_on_a_3d_state_raises():
    params, rho, vel, flags = taylor_green_3d((6, 8, 10))
    state = init_singlephase_state(params, rho, vel, flags, device="cpu")
    with pytest.raises(ValueError, match="D2Q9 only"):
        singlephase_step(params.replace(kbc_type=KBC["A"]), state, device="cpu")
    with pytest.raises(ValueError, match="params.dim=2"):
        singlephase_step(params.replace(dim=2), state, device="cpu")


def test_cpu_runs_leave_launch_counters_at_zero():
    """3D single-phase on the CPU runs B8a's plain version: no launch."""
    kernels.reset_launch_counts()
    params, rho, vel, flags = taylor_green_3d((6, 8, 10))
    state = init_singlephase_state(params, rho, vel, flags, device="cpu")
    runner = SimulationRunner(params, singlephase_step, device="cpu")
    assert runner.prepare(state) is state
    state = runner.run(state, 2, check_every=1)
    p2, s2 = shear_layer(res=(8, 10), device="cpu")
    SimulationRunner(p2, singlephase_step, device="cpu").run(s2, 2)
    assert state.step == 2
    assert all(v == 0 for v in kernels.launch_counts().values())
