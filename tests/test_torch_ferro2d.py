"""The port's 2D ferrofluid model against the JAX package.

* each new op against its JAX twin in float64, inputs from a numpy seed:
  ``poisson_rhs_scaled`` in 2D (the static-field and the staggered-field
  forms), ``magnetic_sweep`` and ``solve_H_int`` on D2Q9 h (9 channels, tau
  1 and 0.8) at rel <= 1e-10 (the gradient's sums associated differently);
  the D2Q9 scalar collapse (``scalar_from_h``, ``s_prev_from_h``,
  ``wall_weight_field``, ``make_cmask``, float32 as both packages take
  them) bit for bit, and the exact-order sweeps
  (``scalar_sweeps_exact`` against ``scalar_sweeps_jnp(order="exact")``)
  at rel <= 1e-12;
* ``two_droplets_2d`` and ``rosensweig_2d`` give the JAX builders' params
  and arrays;
* 3 port steps (float32, CPU) against 3 JAX steps at rel <= 2e-5 (the bar
  of tests/test_torch_ferrofluid.py): in channel form (never primed, 9
  channels) and after ``prime_premac`` in the scalar carry, compared
  through ``compare_views`` with the JAX package's channel run and directly
  with its primed run;
* ``tests/golden/ferro2d.npz`` (reference solver, 10 steps) at the bars of
  tests/test_parity.py, in channel form and in the scalar carry;
* a JAX 2D ``FerrofluidState`` primed into the scalar carry, given to
  ``from_numpy``, steps as the JAX one;
* bfloat16 f/g storage: ``rosensweig_2d`` at 64x64 tracks float32 as
  tests/test_bf16_physics.py measures it (fluid mass, interface height)
  over 300 steps, and shifts the mass as the JAX package's own bfloat16
  mode does (that test's 1000- and 2000-step checkpoints run in
  chip_smoke.py);
* the CPU launches no kernel.
"""

import dataclasses
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lbm_ferrofluid_tpu import models as jmodels  # noqa: E402
from lbm_ferrofluid_tpu.lattice import D2Q9 as JD2Q9  # noqa: E402
from lbm_ferrofluid_tpu.models import scenes as jscenes  # noqa: E402
from lbm_ferrofluid_tpu.ops import magnetic as jmagnetic  # noqa: E402
from lbm_ferrofluid_tpu.ops import scalar_poisson as jscalar  # noqa: E402
from lbm_ferrofluid_tpu.ops.stencils import staggered as jstaggered  # noqa: E402

from lbm_ferrofluid_tpu_torch.lattice import D2Q9  # noqa: E402
from lbm_ferrofluid_tpu_torch.models import (  # noqa: E402
    FerrofluidState,
    SimulationParams,
    SimulationRunner,
    ferrofluid_step,
    from_numpy,
    init_ferrofluid_state,
    prime_premac,
    rosensweig_2d,
    two_droplets_2d,
)
from lbm_ferrofluid_tpu_torch.ops import kernels  # noqa: E402
from lbm_ferrofluid_tpu_torch.ops import magnetic as pmagnetic  # noqa: E402
from lbm_ferrofluid_tpu_torch.ops import scalar_poisson as pscalar  # noqa: E402
from lbm_ferrofluid_tpu_torch.ops.stencils import staggered as pstaggered  # noqa: E402

GOLDEN = pathlib.Path(__file__).parent / "golden"
OBS, FLUID = 2, 1
RG, RF = 0.02381, 0.2508
RES = (24, 20)


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


def _mag_fields(seed, interior=False):
    """Seeded float64 2D magnetic inputs: walls on the two y faces (the
    ferro2d golden's), optionally an interior obstacle pair, phi across
    the interface, a canonical h (tau 1 post-collision: w_q s in the
    fluid, w_q s_prev(x + e_q) in the wall channels a fluid cell reads)."""
    rng = np.random.default_rng(seed)
    H, W = RES
    mf = np.full((1, 1, H, W), OBS, np.uint8)
    mf[..., 1:-1, :] = FLUID
    if interior:
        mf[..., H // 2, 4:6] = OBS
    phi = np.clip(rng.uniform(-1.5, 1.5, (1, 1, H, W)), -1.0, 1.0)
    s = rng.uniform(-1.0, 1.0, (1, 1, H, W)) * (mf != OBS)
    sp = rng.uniform(-1.0, 1.0, (1, 1, H, W)) * (mf != OBS)
    return dict(mflags=mf, phi=phi, s=s, sp=sp,
                h=rng.uniform(-0.1, 0.1, (1, 9, H, W)),
                H_ext=np.stack([np.zeros((H, W)), np.full((H, W), 100.0)])[None])


def _canonical_h(d):
    """The D2Q9 channel h that a tau == 1 solve leaves behind for (s,
    s_prev), in float32 (JAX ``h_from_scalar``)."""
    rhs = np.zeros_like(d["s"], np.float32)
    h = jscalar.h_from_scalar(jnp.asarray(d["s"], jnp.float32),
                              jnp.asarray(d["sp"], jnp.float32), jnp.asarray(rhs),
                              jnp.asarray(d["mflags"]), "float32")
    return np.asarray(h)


# ---------------------------------------------------------------- ops, float64
@pytest.mark.parametrize("form", ["static", "staggered"])
def test_poisson_rhs_2d_matches_jax(form):
    d = _mag_fields(1)
    jmac = jstaggered(jnp.asarray(d["H_ext"]))
    pmac = pstaggered(T(d["H_ext"]))
    static = (0.0, 100.0) if form == "static" else None
    want = jmagnetic.poisson_rhs_scaled(jnp.asarray(d["phi"]), jnp.asarray(d["mflags"]),
                                        list(jmac), static, tau=0.8, dx=1.0, dt=1.0, dim=2)
    got = pmagnetic.poisson_rhs_scaled(T(d["phi"]), T(d["mflags"]), static, tau=0.8, dx=1.0,
                                       dt=1.0, H_ext_mac=pmac)
    assert rel(got, want) <= 1e-12


def test_magnetic_sweep_2d_matches_jax():
    d = _mag_fields(2, interior=True)
    jmac = jstaggered(jnp.asarray(d["H_ext"]))
    pmac = pstaggered(T(d["H_ext"]))
    want = jmagnetic.magnetic_sweep(JD2Q9, jnp.asarray(d["h"]), jnp.asarray(d["phi"]),
                                    jnp.asarray(d["mflags"]), list(jmac), tau=0.8)
    got = pmagnetic.magnetic_sweep(D2Q9, T(d["h"]), T(d["phi"]), T(d["mflags"]), pmac, tau=0.8)
    for name, a, b in zip(("H_int", "h"), got, want, strict=True):
        assert rel(a, b) <= 1e-10, name


@pytest.mark.parametrize("tau", [1.0, 0.8])
@pytest.mark.parametrize("interior", [False, True], ids=["walls", "interior_obstacle"])
def test_solve_h_int_d2q9_matches_jax(interior, tau):
    d = _mag_fields(3, interior)
    kw = dict(tau=tau, n_iters=12, dx=1.0, dt=1.0)
    want = jmagnetic.solve_H_int(JD2Q9, jnp.asarray(d["h"]), jnp.asarray(d["phi"]),
                                 jnp.asarray(d["mflags"]), None, h2_ext=(0.0, 100.0),
                                 use_pallas=False, **kw)
    got = pmagnetic.solve_H_int(D2Q9, T(d["h"]), T(d["phi"]), T(d["mflags"]), None,
                                h2_ext=(0.0, 100.0), **kw)
    for name, a, b in zip(("H2", "h"), got, want, strict=True):
        assert rel(a, b) <= 1e-10, name


@pytest.mark.parametrize("interior", [False, True], ids=["walls", "interior_obstacle"])
def test_d2q9_scalar_conversions_match_jax(interior):
    d = _mag_fields(4, interior)
    h, mf = _canonical_h(d), d["mflags"]
    for name in ("scalar_from_h", "s_prev_from_h"):
        want = np.asarray(getattr(jscalar, name)(jnp.asarray(h), jnp.asarray(mf)))
        got = getattr(pscalar, name)(T(h), T(mf))
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
    for name in ("wall_weight_field", "make_cmask"):
        np.testing.assert_array_equal(getattr(pscalar, name)(T(mf)).numpy(),
                                      np.asarray(getattr(jscalar, name)(jnp.asarray(mf))),
                                      err_msg=name)
    # the collapse recovers the pair from the channel form: s at every
    # fluid cell, s_prev where a wall neighbour stores it
    wall = np.asarray(jscalar.wall_weight_field(jnp.asarray(mf))) > 0
    s = pscalar.scalar_from_h(T(h), T(mf)).numpy()
    sp = pscalar.s_prev_from_h(T(h), T(mf)).numpy()
    assert rel(s, d["s"]) <= 1e-6 and rel(sp[wall], d["sp"][wall]) <= 1e-6


@pytest.mark.parametrize("interior", [False, True], ids=["walls", "interior_obstacle"])
def test_exact_order_sweeps_match_jax(interior):
    d = _mag_fields(5, interior)
    rhs = np.random.default_rng(6).uniform(-1e-3, 1e-3, d["s"].shape) * (d["mflags"] == FLUID)
    want = jscalar.scalar_sweeps_jnp(jnp.asarray(d["s"]), jnp.asarray(d["sp"]),
                                     jnp.asarray(rhs), None, jnp.asarray(d["mflags"]), 9,
                                     order="exact")
    got = pscalar.scalar_sweeps_exact(T(d["s"]), T(d["sp"]), T(rhs), T(d["mflags"]), 9)
    for name, a, b in zip(("psi", "s", "s_prev"), got, want, strict=True):
        assert rel(a, b) <= 1e-12, name


def test_scalar_solve_matches_channel_solve_at_tau_1():
    """The collapse on D2Q9: 30 scalar sweeps from (s, s_prev) give the H2
    and the pair that 30 channel sweeps give from the canonical h (float32,
    boundary-ring walls, as the collapse requires)."""
    d = _mag_fields(7)
    mf = T(d["mflags"])
    h = T(_canonical_h(d))
    rhs = pmagnetic.poisson_rhs_scaled(T(d["phi"]).float(), mf, (0.0, 100.0), tau=1.0,
                                       dx=1.0, dt=1.0)
    H2c, hc = pmagnetic.solve_H_int(D2Q9, h, None, mf, None, tau=1.0, rhs_scaled=rhs,
                                    h2_ext=(0.0, 100.0))
    s2 = torch.cat([pscalar.scalar_from_h(h, mf), pscalar.s_prev_from_h(h, mf)], dim=1)
    H2s, s2 = pmagnetic.solve_H_int_scalar(s2, pscalar.make_cmask(mf), rhs, h2_ext=(0.0, 100.0),
                                           magnetic_flags=mf)
    assert rel(H2s, H2c) <= 1e-6
    a, b = pscalar.compare_views(s2, hc, mf)
    assert rel(a, b) <= 1e-5


# ---------------------------------------------------------------- scenes and steps
SCENES = {"two_droplets_2d": (jscenes.two_droplets_2d, two_droplets_2d, (16, 24)),
          "rosensweig_2d": (jscenes.rosensweig_2d, rosensweig_2d, (20, 24))}


@pytest.mark.parametrize("name", sorted(SCENES))
def test_scene_matches_jax(name):
    jbuild, pbuild, res = SCENES[name]
    jp, js = jbuild(res=res)
    pp, ps = pbuild(res=res, device="cpu")
    assert pp.to_json() == jp.to_json()
    assert isinstance(ps, FerrofluidState) and ps.h.shape[1] == 9
    for fld in dataclasses.fields(js):
        a, b = getattr(ps, fld.name), getattr(js, fld.name)
        if fld.name in ("f", "g"):
            assert rel(a, b) <= 1e-6, fld.name
        elif fld.name == "step":
            assert a == int(b) == 0
        elif b is None:
            assert a is None, fld.name
        elif isinstance(b, tuple):
            for x, y in zip(a, b, strict=True):
                np.testing.assert_array_equal(x.numpy(), np.asarray(y))
        else:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-9,
                                       err_msg=fld.name)


def _steps(jp, js, n, prime=False):
    """``n`` JAX steps (unprimed: the 9-channel solve) and ``n`` port steps
    from the same state, the port's primed into the scalar carry when
    ``prime``."""
    pp = SimulationParams.from_json(jp.to_json())
    ps = from_numpy(_jax_fields(js), device="cpu")
    if prime:
        ps = prime_premac(pp, ps, device="cpu")
        assert ps.h.shape[1] == 2 and ps.premac is None and ps.cmask is not None
    for _ in range(n):
        js = jmodels.ferrofluid_step(jp, js)
        ps = ferrofluid_step(pp, ps, device="cpu")
    assert ps.step == int(js.step) == n
    return ps, js


FIELDS = ("f", "g", "rho", "vel", "density", "pressure", "force", "phi")


@pytest.mark.parametrize("form", ["channel", "scalar_carry"])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_three_steps_match_jax_step(name, form):
    jbuild, _, res = SCENES[name]
    ps, js = _steps(*jbuild(res=res), 3, prime=form == "scalar_carry")
    for fld in FIELDS:
        r = rel(getattr(ps, fld), getattr(js, fld))
        assert r <= 2e-5, f"{fld}: max rel dev {r:.2e}"
    if form == "channel":
        assert ps.h.shape[1] == 9 and ps.cmask is None
        assert rel(ps.h, js.h) <= 2e-5
    else:
        a, b = pscalar.compare_views(ps.h, T(js.h), ps.magnetic_flags)
        assert rel(a, b) <= 2e-5


def test_primed_steps_match_the_primed_jax_steps():
    """Both packages prime a 2D state into the scalar carry only (no premac)
    and step it with the exact-order sweeps."""
    jp, js = jscenes.rosensweig_2d(res=(20, 24))
    js = jmodels.prime_premac(jp, js)
    assert js.h.shape[1] == 2 and js.premac is None
    ps, js = _steps(jp, js, 3)
    for fld in FIELDS + ("h",):
        r = rel(getattr(ps, fld), getattr(js, fld))
        assert r <= 2e-5, f"{fld}: max rel dev {r:.2e}"


def _assert_close(got, want, name, atol=2e-5, rtol=2e-4):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    err = np.abs(got - want).max()
    scale = np.abs(want).max() + 1e-30
    assert err <= atol + rtol * scale, f"{name}: max|err|={err:.3e} scale={scale:.3e}"


@pytest.mark.parametrize("form", ["channel", "scalar_carry"])
def test_golden_ferro2d(form):
    """tests/test_parity.py:test_ferro2d_parity through the port; the scalar
    carry's h through ``compare_views``."""
    d = np.load(GOLDEN / "ferro2d.npz")
    params = SimulationParams(dim=2, density_gas=RG, density_fluid=RF, rho_gas=RG, rho_fluid=RF,
                              kappa=0.5, tau_f=0.68, tau_g=0.68, mag_strength=100.0,
                              poisson_iters=30)
    mflags = np.full((1, 1, *RES), OBS, np.uint8)
    mflags[..., 1:-1, :] = FLUID
    state = init_ferrofluid_state(params, d["rho0"], d["den0"], np.zeros((1, 2, *RES),
                                  np.float32), d["flags"], mflags, device="cpu")
    if form == "scalar_carry":
        state = prime_premac(params, state, device="cpu")
    for _ in range(10):
        state = ferrofluid_step(params, state, device="cpu")
    if form == "channel":
        _assert_close(state.h, d["h"], "h")
    else:
        a, b = pscalar.compare_views(state.h, T(d["h"]), state.magnetic_flags)
        _assert_close(a, b, "h")
    for attr, key in (("f", "f"), ("g", "g"), ("vel", "vel"), ("density", "den")):
        _assert_close(getattr(state, attr), d[key], attr)


def test_jax_primed_state_carried_across_steps_as_jax():
    jp, js = jscenes.two_droplets_2d(res=(16, 24))
    js = jmodels.prime_premac(jp, js)
    for _ in range(2):
        js = jmodels.ferrofluid_step(jp, js)
    ps = from_numpy(_jax_fields(js), device="cpu")
    assert isinstance(ps, FerrofluidState) and ps.step == 2 and ps.h.shape[1] == 2
    assert len(ps.H_ext_mac) == 2
    pp = SimulationParams.from_json(jp.to_json())
    ps = ferrofluid_step(pp, ps, device="cpu")
    js = jmodels.ferrofluid_step(jp, js)
    for fld in FIELDS + ("h",):
        assert rel(getattr(ps, fld), getattr(js, fld)) <= 2e-5, fld


def _pool_run(fg_dtype, steps):
    """``steps`` port steps of ``rosensweig_2d`` at 64x64 with f, g and h
    stored in ``fg_dtype`` (the runner primes h into the float32 carry)."""
    params, state = rosensweig_2d(res=(64, 64), device="cpu")
    params = params.replace(fg_dtype=fg_dtype, h_dtype=fg_dtype)
    state = init_ferrofluid_state(params, state.rho, state.density, state.vel, state.flags,
                                  state.magnetic_flags, device="cpu")
    state = SimulationRunner(params, ferrofluid_step, device="cpu").run(state, steps)
    return state, _pool_measures(params, state.density, state.rho, state.flags)


def _jax_pool_run(fg_dtype, steps):
    """The same run in the JAX package (tests/test_bf16_physics.py's)."""
    jp, js = jscenes.rosensweig_2d(res=(64, 64), mag_strength=100.0)
    jp = jp.replace(fg_dtype=fg_dtype, h_dtype=fg_dtype)
    dt = jnp.dtype(fg_dtype)
    js = dataclasses.replace(js, f=js.f.astype(dt), g=js.g.astype(dt), h=js.h.astype(dt))
    js = jmodels.SimulationRunner(jp, jmodels.ferrofluid_step_impl).run(js, steps)
    return _pool_measures(jp, *(T(getattr(js, k)) for k in ("density", "rho", "flags")))


def _pool_measures(params, density, rho, flags):
    """tests/test_bf16_physics.py's measures: the fill height of each
    column and the fluid cells' mass."""
    mid = 0.5 * (params.density_gas + params.density_fluid)
    return {
        "finite": bool(torch.isfinite(density).all()),
        "heights": (density[0, 0] > mid).sum(dim=0).double(),
        "mass": float((rho.double() * (flags == FLUID))[0, 0].sum()),
    }


def test_bf16_storage_tracks_f32_interface_dynamics():
    """bfloat16 f/g storage (h primes into the float32 carry) against float32
    on ``rosensweig_2d`` at 64x64, with tests/test_bf16_physics.py's
    measures and bars, over 300 steps here (its 1000- and 2000-step
    checkpoints run in chip_smoke.py, where they hold: -2.8e-3 and +2.2e-4
    in mass): finite, fluid mass at rtol 5e-3, the fill height per column
    within 2 cells pointwise and its mean within 1 cell; and the port's
    bfloat16 mass shift within 1e-3 of the JAX package's own.  The bfloat16
    mass swings about float32's in both packages alike (measured at
    300/600/1000 steps: +4.0e-3/-6.0e-3/-3.6e-3 in the port,
    +4.2e-3/-5.7e-3/-2.9e-3 in JAX), so no horizon between checkpoints
    holds 5e-3 in either; the comparison with JAX is what this test adds.
    The 2D step is thousands of small ops, so the test runs PyTorch on one
    thread (the results do not depend on it; the CPU's other workers do
    not slow it)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        s32, a = _pool_run("float32", 300)
        s16, b = _pool_run("bfloat16", 300)
    finally:
        torch.set_num_threads(threads)
    ja, jb = _jax_pool_run("float32", 300), _jax_pool_run("bfloat16", 300)
    assert s16.f.dtype == s16.g.dtype == torch.bfloat16 and s16.h.dtype == torch.float32
    assert a["finite"] and b["finite"] and ja["finite"] and jb["finite"]
    np.testing.assert_allclose(b["mass"], a["mass"], rtol=5e-3)
    assert float((b["heights"] - a["heights"]).abs().max()) <= 2
    assert abs(float(b["heights"].mean() - a["heights"].mean())) <= 1.0
    port, jax_own = b["mass"] / a["mass"] - 1.0, jb["mass"] / ja["mass"] - 1.0
    assert abs(port - jax_own) <= 1e-3, f"bf16 mass shift: port {port:.3e}, JAX {jax_own:.3e}"


@pytest.mark.slow  # 1000 steps in both packages and both storage types (under a minute)
def test_bf16_mass_swing_matches_jax():
    """The bfloat16 fluid mass swings about float32's as in the JAX
    package's own bfloat16 mode: at 300, 600 and 1000 steps the port's
    shift is within 1e-3 of JAX's (measured +4.0e-3/-6.0e-3/-3.6e-3 in the
    port against +4.2e-3/-5.7e-3/-2.9e-3 in JAX), though at 600 steps
    neither holds tests/test_bf16_physics.py's 5e-3."""
    marks, shift = (300, 600, 1000), {}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for pkg in ("port", "jax"):
            mass = {}
            for dtype in ("float32", "bfloat16"):
                done, out = 0, []
                if pkg == "port":
                    params, st = rosensweig_2d(res=(64, 64), device="cpu")
                    params = params.replace(fg_dtype=dtype, h_dtype=dtype)
                    st = init_ferrofluid_state(params, st.rho, st.density, st.vel, st.flags,
                                               st.magnetic_flags, device="cpu")
                    runner = SimulationRunner(params, ferrofluid_step, device="cpu")
                else:
                    params, st = jscenes.rosensweig_2d(res=(64, 64), mag_strength=100.0)
                    params = params.replace(fg_dtype=dtype, h_dtype=dtype)
                    dt = jnp.dtype(dtype)
                    st = dataclasses.replace(st, f=st.f.astype(dt), g=st.g.astype(dt),
                                             h=st.h.astype(dt))
                    runner = jmodels.SimulationRunner(params, jmodels.ferrofluid_step_impl)
                for t in marks:
                    st = runner.run(st, t - done)
                    done = t
                    out.append(_pool_measures(params, *(T(np.asarray(getattr(st, k)))
                                                        for k in ("density", "rho", "flags")))
                               ["mass"])
                mass[dtype] = out
            shift[pkg] = [b / a - 1.0 for a, b in zip(mass["float32"], mass["bfloat16"])]
    finally:
        torch.set_num_threads(threads)
    for t, p, j in zip(marks, shift["port"], shift["jax"]):
        assert abs(p - j) <= 1e-3, f"step {t}: port {p:.3e}, JAX {j:.3e}"


def test_cpu_runs_leave_launch_counters_at_zero():
    kernels.reset_launch_counts()
    for build in (two_droplets_2d, rosensweig_2d):
        params, state = build(res=(10, 12), device="cpu")
        state = SimulationRunner(params, ferrofluid_step, device="cpu").run(state, 2,
                                                                           check_every=1)
        assert state.step == 2 and state.h.shape[1] == 2
    assert all(v == 0 for v in kernels.launch_counts().values())
