"""The port's Rosensweig step as a whole, against the JAX package.

* the scene builders give equal initial states;
* from the same numpy init, 3 port steps (prime_premac + steady state,
  float32, plain versions on the CPU) track 3 JAX steps with
  ``use_pallas=False`` at rel <= 2e-5 — the bar of
  tests/test_fastpath_dispatch.py for the same comparison: the port's
  scalar tau == 1 carry and grouped tap order against the channel-form
  solve, both float32, differ at the FMA/reassociation level;
* the step steps the state it is given: an unprimed state runs the
  un-carried step (premac None, 19-channel h compared directly) and a
  5-leaf premac made by the JAX package the epilogue steady state, each
  against the JAX steps at 2e-5; the epilogue steady state equals the
  capillogue one on the CPU;
* ``tests/golden/ferro3d.npz`` (the reference solver) is met at the bars
  of tests/test_parity.py:_assert_close, primed and un-carried;
* the carried structure, the NotImplementedError scope and the launch
  counters (0 on the CPU, on every route);
* the channel-form solve (tau != 1, ``scalar_carry=False``, an interior
  magnetic obstacle): 3 port steps against 3 JAX steps at 2e-5 with the
  19-channel h compared directly, against the port's own scalar carry at
  tau == 1 at 2e-5, the ferro3d golden at test_parity.py's bars, and
  float64 storage (plain path) against JAX float64 steps at 1e-10 —
  the same formulas, with the solve's sums associated differently.

With the scalar carry, h is compared through the port's own
``compare_views``: the port carries (s, s_prev) where the JAX run (never
primed) carries the 19-channel h.
"""

import dataclasses
import importlib
import math
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lbm_ferrofluid_tpu import models as jmodels  # noqa: E402
from lbm_ferrofluid_tpu.lattice import D3Q19 as JD3Q19  # noqa: E402
from lbm_ferrofluid_tpu.models import ferrofluid as jff  # noqa: E402
from lbm_ferrofluid_tpu.models import scenes as jscenes  # noqa: E402

from lbm_ferrofluid_tpu_torch.models import (  # noqa: E402
    SimulationParams,
    SimulationRunner,
    ferrofluid_step,
    from_numpy,
    init_ferrofluid_state,
    phi_field,
    prime_premac,
    rosensweig_3d,
    to_numpy,
)
from lbm_ferrofluid_tpu_torch.ops import kernels  # noqa: E402
from lbm_ferrofluid_tpu_torch.ops.scalar_poisson import compare_views  # noqa: E402

# ops/__init__ re-exports the function ``stream`` over the module's name
jstream = importlib.import_module("lbm_ferrofluid_tpu.ops.stream")

GOLDEN = pathlib.Path(__file__).parent / "golden"
RES = (10, 12, 14)


def rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _jax_fields(state):
    """A JAX state as numpy arrays keyed by field name (None/tuples kept)."""
    def conv(v):
        if v is None:
            return None
        if isinstance(v, tuple):
            return tuple(conv(x) for x in v)
        return np.asarray(v)
    return {f.name: conv(getattr(state, f.name)) for f in dataclasses.fields(state)}


def _h_rel(port_state, h_channel):
    a, b = compare_views(
        port_state.h, torch.as_tensor(np.array(h_channel)), port_state.magnetic_flags
    )
    return rel(a, b), a, b


def test_scene_matches_jax():
    jp, js = jscenes.rosensweig_3d(res=RES)
    pp, ps = rosensweig_3d(res=RES, device="cpu")
    assert pp.to_json() == jp.to_json()
    for name in ("f", "g"):
        assert rel(getattr(ps, name), getattr(js, name)) <= 1e-6, name
    for name in ("rho", "vel", "density", "pressure", "flags", "magnetic_flags", "h",
                 "H_ext"):
        np.testing.assert_allclose(
            getattr(ps, name).numpy(), np.asarray(getattr(js, name)), rtol=1e-6,
            atol=1e-9, err_msg=name,
        )
    for a, b in zip(ps.H_ext_mac, js.H_ext_mac):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert ps.step == int(js.step) == 0


def test_three_steps_match_jax_step():
    jp, js = jscenes.rosensweig_3d(res=RES)
    pp = SimulationParams.from_json(jp.to_json())
    ps = from_numpy(_jax_fields(js), device="cpu")
    jpp = jp.replace(use_pallas=False)
    for _ in range(3):
        js = jmodels.ferrofluid_step(jpp, js)
    ps = prime_premac(pp, ps, device="cpu")
    for _ in range(3):
        ps = ferrofluid_step(pp, ps, device="cpu")
    assert ps.step == int(js.step) == 3
    for name in ("f", "g", "density", "vel", "pressure"):
        r = rel(getattr(ps, name), getattr(js, name))
        assert r <= 2e-5, f"{name}: max rel dev {r:.2e}"
    assert ps.h.shape[1] == 2 and js.h.shape[1] == 19
    r, _, _ = _h_rel(ps, js.h)
    assert r <= 2e-5, f"h (collapse contract): max rel dev {r:.2e}"


def _assert_close(got, want, name, atol=2e-5, rtol=2e-4):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    err = np.abs(got - want).max()
    scale = np.abs(want).max() + 1e-30
    assert err <= atol + rtol * scale, f"{name}: max|err|={err:.3e} scale={scale:.3e}"


def ferro3d_params():
    """tests/test_parity.py:test_ferro3d_parity's configuration."""
    return SimulationParams(
        dim=3, density_gas=0.02381, density_fluid=0.2508, rho_gas=0.02381,
        rho_fluid=0.2508, kappa=0.01, tau_f=0.68, tau_g=0.68, gravity=1e-4,
        contact_angle=0.5 * math.pi, mag_strength=85.0, poisson_iters=30,
    )


def test_golden_ferro3d():
    d = np.load(GOLDEN / "ferro3d.npz")
    params = ferro3d_params()
    mflags = np.full((1, 1, *RES), 2, np.uint8)
    mflags[..., 1:-1, :, 1:-1] = 1
    state = init_ferrofluid_state(
        params, d["rho0"], d["den0"], np.zeros((1, 3, *RES), np.float32),
        d["flags"], mflags, device="cpu",
    )
    _assert_close(state.f, d["f0"], "f_init", atol=1e-6)
    _assert_close(state.g, d["g0"], "g_init", atol=1e-6)
    state = prime_premac(params, state, device="cpu")
    for _ in range(8):
        state = ferrofluid_step(params, state, device="cpu")
    _, a, b = _h_rel(state, d["h"])
    _assert_close(a, b, "h")
    _assert_close(state.f, d["f"], "f")
    _assert_close(state.g, d["g"], "g")
    _assert_close(state.vel, d["vel"], "vel")
    _assert_close(state.density, d["den"], "density")


def test_steady_state_structure():
    params, state = rosensweig_3d(res=(6, 8, 10), device="cpu")
    state = prime_premac(params, state, device="cpu")
    for _ in range(2):
        assert state.premac is not None and len(state.premac) == 6
        assert state.phi is None and state.force is None and state.H_ext is None
        assert state.h.shape == (1, 2, 6, 8, 10) and state.cmask is not None
        state = ferrofluid_step(params, state, device="cpu")
    phi = phi_field(params, state)
    expect = -(2.0 * (state.density - params.density_gas)
               / (params.density_fluid - params.density_gas) - 1.0)
    np.testing.assert_array_equal(phi.numpy(), expect.numpy())
    assert bool(torch.isfinite(phi).all())
    # the state round-trips through numpy unchanged
    back = from_numpy(to_numpy(state), device="cpu")
    for f in dataclasses.fields(state):
        a, b = getattr(state, f.name), getattr(back, f.name)
        if isinstance(a, tuple):
            assert all(torch.equal(x, y) for x, y in zip(a, b))
        elif torch.is_tensor(a):
            assert torch.equal(a, b), f.name
        else:
            assert a == b, f.name


#: configuration -> (change, what the message names): its ROADMAP item, or,
#: for a storage dtype the JAX package has no mode for, the dtype; 2D params
#: on this 3D state and KBC on D3Q19 raise ``ValueError`` (the KBC message is
#: the JAX package's own), the rest ``NotImplementedError``
_UNSUPPORTED = {
    "2D": (dict(dim=2), "params.dim=2 .D2Q9. does not match the state"),
    "KBC": (dict(kbc_type=0b10000101), "D2Q9 only"),
    "float16 f/g": (dict(fg_dtype="float16"), "'float16'.*no float16 mode"),
    "float16 h": (dict(h_dtype="float16"), "'float16'.*no float16 mode"),
    "phys_extent": (dict(phys_extent=(6, 8, 10)), "ROADMAP A8"),
    # the JAX step runs an out-of-plane field only on the padded layout
    "h_ext_axis=2": (dict(h_ext_axis=2), "ROADMAP A8"),
}


@pytest.mark.parametrize("case", sorted(_UNSUPPORTED))
def test_unsupported_configs_raise(case):
    params, state = rosensweig_3d(res=(6, 8, 10), device="cpu")
    change, names = _UNSUPPORTED[case]
    error = ValueError if case in ("2D", "KBC") else NotImplementedError
    with pytest.raises(error, match=names):
        ferrofluid_step(params.replace(**change), state, device="cpu")


def test_batched_state_raises():
    params, state = rosensweig_3d(res=(6, 8, 10), batch=2, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP A12"):
        prime_premac(params, state, device="cpu")


def test_cpu_runs_leave_launch_counters_at_zero():
    """The carried steady state (through the runner), the un-carried step
    and the epilogue steady state on the CPU launch nothing."""
    kernels.reset_launch_counts()
    params, s0 = rosensweig_3d(res=(6, 8, 10), device="cpu")
    state = SimulationRunner(params, ferrofluid_step, device="cpu").run(
        s0, 2, check_every=1
    )
    assert state.step == 2
    assert kernels.launch_counts(kernels.PATHS["ferrofluid"]) == {
        "B1": 0, "B2": 0, "B3": 0, "B4": 0
    }
    uncarried = ferrofluid_step(params, s0, device="cpu")
    assert uncarried.premac is None
    five = _five_leaf(params, s0)
    assert len(ferrofluid_step(params, five, device="cpu").premac) == 5
    for path in ("ferrofluid_uncarried", "ferrofluid_epilogue"):
        assert set(kernels.launch_counts(kernels.PATHS[path]).values()) == {0}, path
    assert kernels.launch_counts(["B5", "B10b"]) == {"B5": 0, "B10b": 0}
    assert all(v == 0 for v in kernels.launch_counts().values())


# ------------------------------------------------- un-carried and epilogue routes
def _five_leaf(params, state):
    """The epilogue steady state as the port builds it from its own prime:
    the 6-leaf premac cut to its 5 macros, phi/force/H_ext kept as the JAX
    package's 5-leaf prime keeps them (:1052-1077)."""
    primed = prime_premac(params, state, device="cpu")
    return state.replace(h=primed.h, cmask=primed.cmask, premac=primed.premac[:5])


def test_uncarried_steps_match_jax_step():
    """An unprimed state steps un-carried, as the JAX step does: premac
    stays None, h keeps its 19 channels (compared directly), phi and force
    are tensors, H_ext is kept."""
    jp, js = jscenes.rosensweig_3d(res=RES)
    pp = SimulationParams.from_json(jp.to_json())
    ps = from_numpy(_jax_fields(js), device="cpu")
    jpp = jp.replace(use_pallas=False)
    for _ in range(3):
        js = jmodels.ferrofluid_step(jpp, js)
        ps = ferrofluid_step(pp, ps, device="cpu")
    assert ps.step == int(js.step) == 3
    assert ps.premac is None and js.premac is None
    assert ps.h.shape[1] == 19 and ps.cmask is None
    assert ps.H_ext is not None and torch.equal(ps.H_ext, torch.as_tensor(np.array(js.H_ext)))
    for name in ("f", "g", "density", "vel", "pressure", "h", "phi", "force"):
        r = rel(getattr(ps, name), getattr(js, name))
        assert r <= 2e-5, f"{name}: max rel dev {r:.2e}"


def test_golden_ferro3d_uncarried():
    """tests/golden/ferro3d.npz through the un-carried step: 8 steps with no
    priming, h compared directly."""
    d = np.load(GOLDEN / "ferro3d.npz")
    params = ferro3d_params()
    mflags = np.full((1, 1, *RES), 2, np.uint8)
    mflags[..., 1:-1, :, 1:-1] = 1
    state = init_ferrofluid_state(
        params, d["rho0"], d["den0"], np.zeros((1, 3, *RES), np.float32),
        d["flags"], mflags, device="cpu",
    )
    for _ in range(8):
        state = ferrofluid_step(params, state, device="cpu")
    assert state.premac is None and state.h.shape[1] == 19
    _assert_close(state.h, d["h"], "h")
    _assert_close(state.f, d["f"], "f")
    _assert_close(state.g, d["g"], "g")
    _assert_close(state.vel, d["vel"], "vel")
    _assert_close(state.density, d["den"], "density")


def _jax_five_leaf(jp, js):
    """The JAX package's 5-leaf prime (ferrofluid.py:1050-1077, the
    capillogue gated off, as for f32 storage on 256^2 planes): premac from
    its plain stream_bounce_macro/moments, h converted to the scalar carry
    where the collapse applies."""
    _, rho, vel, den = jstream.stream_bounce_macro(
        JD3Q19, js.f, js.flags, js.rho, js.vel, c=jp.dx / jp.dt, rho_gas=jp.rho_gas,
        rho_fluid=jp.rho_fluid, density_gas=jp.density_gas,
        density_fluid=jp.density_fluid, use_pallas=False,
    )
    _, m0g, m1g = jstream.stream_bounce_moments(JD3Q19, js.g, js.flags, use_pallas=False)
    conv = jff._scalar_convert(jp, js)
    updates = {} if conv is None else {"h": conv[0], "cmask": conv[1]}
    return dataclasses.replace(js, premac=(rho, vel, den, m0g, m1g), **updates)


@pytest.mark.parametrize("scalar_carry", [True, False], ids=["scalar_carry", "channel"])
def test_five_leaf_state_from_jax_steps_as_jax(scalar_carry):
    """A JAX state primed to the epilogue steady state, handed over with
    from_numpy: the port steps it on that route (premac stays 5 leaves,
    phi and force tensors) and tracks the JAX steps (use_pallas=False, which
    recompute the same macros from f and g) at 2e-5; the scalar carry's h
    through compare_views."""
    jp, js = jscenes.rosensweig_3d(res=RES)
    jp = jp.replace(scalar_carry=scalar_carry)
    assert jp.mag_flags_shell
    j5 = _jax_five_leaf(jp, js)
    assert j5.h.shape[1] == (2 if scalar_carry else 19)
    pp = SimulationParams.from_json(jp.to_json())
    ps = from_numpy(_jax_fields(j5), device="cpu")
    assert len(ps.premac) == 5
    jpp = jp.replace(use_pallas=False)
    for _ in range(3):
        js = jmodels.ferrofluid_step(jpp, js)
        ps = ferrofluid_step(pp, ps, device="cpu")
    assert len(ps.premac) == 5 and ps.phi is not None and ps.force is not None
    for name in ("f", "g", "density", "vel", "pressure", "phi", "force"):
        r = rel(getattr(ps, name), getattr(js, name))
        assert r <= 2e-5, f"{name}: max rel dev {r:.2e}"
    if scalar_carry:
        r, _, _ = _h_rel(ps, js.h)
    else:
        r = rel(ps.h, js.h)
    assert r <= 2e-5, f"h: max rel dev {r:.2e}"
    # the carried macros are the next step's, as a prologue on f/g gives them
    want = kernels.lbm_prologue_plain(ps.f, ps.g, ps.flags, ps.rho, ps.vel, c=1.0,
                                      rho_gas=pp.rho_gas, rho_fluid=pp.rho_fluid,
                                      density_gas=pp.density_gas,
                                      density_fluid=pp.density_fluid)
    for a, b in zip(ps.premac, want, strict=True):
        assert torch.equal(a, b)


def test_epilogue_steady_state_matches_capillogue_steady_state():
    """The 5-leaf and the 6-leaf routes compute the same function
    (capillogue.py:826-829); on the CPU both run the same plain ops."""
    params, s0 = rosensweig_3d(res=(6, 8, 10), device="cpu")
    s6 = prime_premac(params, s0, device="cpu")
    s5 = _five_leaf(params, s0)
    for _ in range(3):
        s6 = ferrofluid_step(params, s6, device="cpu")
        s5 = ferrofluid_step(params, s5, device="cpu")
    assert len(s6.premac) == 6 and len(s5.premac) == 5
    for name in ("f", "g", "h", "rho", "vel", "density", "pressure"):
        assert torch.equal(getattr(s5, name), getattr(s6, name)), name
    for a, b in zip(s5.premac, s6.premac[:5]):
        assert torch.equal(a, b)


# ---------------------------------------------------------------- channel form
def _interior_obstacle(jp, js):
    """tau == 1 with a 2x2x2 magnetic obstacle block inside the domain: the
    scalar collapse must decline (its precondition is boundary-ring
    obstacles only)."""
    mf = np.array(js.magnetic_flags)
    mf[..., 4:6, 5:7, 6:8] = 2
    return jp.replace(mag_flags_shell=False), dataclasses.replace(
        js, magnetic_flags=jnp.asarray(mf))


_CHANNEL = {
    "tau=0.8": lambda jp, js: (jp.replace(tau=0.8), js),
    "scalar_carry=False": lambda jp, js: (jp.replace(scalar_carry=False), js),
    "interior obstacle": _interior_obstacle,
}


@pytest.mark.parametrize("case", sorted(_CHANNEL))
def test_channel_form_three_steps_match_jax_step(case):
    jp, js = _CHANNEL[case](*jscenes.rosensweig_3d(res=RES))
    pp = SimulationParams.from_json(jp.to_json())
    ps = from_numpy(_jax_fields(js), device="cpu")
    jpp = jp.replace(use_pallas=False)
    for _ in range(3):
        js = jmodels.ferrofluid_step(jpp, js)
    for _ in range(3):
        ps = ferrofluid_step(pp, ps, device="cpu")
    assert ps.h.shape[1] == 19 and ps.cmask is None
    for name in ("f", "g", "density", "vel", "pressure", "h"):
        r = rel(getattr(ps, name), getattr(js, name))
        assert r <= 2e-5, f"{name}: max rel dev {r:.2e}"


def test_channel_form_matches_scalar_carry():
    params, s0 = rosensweig_3d(res=RES, device="cpu")
    sc = prime_premac(params, s0, device="cpu")
    ch = prime_premac(params.replace(scalar_carry=False), s0, device="cpu")
    for _ in range(3):
        sc = ferrofluid_step(params, sc, device="cpu")
        ch = ferrofluid_step(params.replace(scalar_carry=False), ch, device="cpu")
    assert sc.h.shape[1] == 2 and ch.h.shape[1] == 19
    for name in ("f", "g", "density", "vel", "pressure"):
        r = rel(getattr(ch, name), getattr(sc, name))
        assert r <= 2e-5, f"{name}: max rel dev {r:.2e}"
    r, _, _ = _h_rel(sc, ch.h.numpy())
    assert r <= 2e-5, f"h: max rel dev {r:.2e}"


def test_golden_ferro3d_channel_form():
    d = np.load(GOLDEN / "ferro3d.npz")
    params = ferro3d_params().replace(scalar_carry=False)
    mflags = np.full((1, 1, *RES), 2, np.uint8)
    mflags[..., 1:-1, :, 1:-1] = 1
    state = init_ferrofluid_state(
        params, d["rho0"], d["den0"], np.zeros((1, 3, *RES), np.float32),
        d["flags"], mflags, device="cpu",
    )
    state = prime_premac(params, state, device="cpu")
    for _ in range(8):
        state = ferrofluid_step(params, state, device="cpu")
    assert state.h.shape[1] == 19 and len(state.premac) == 6
    _assert_close(state.h, d["h"], "h")
    _assert_close(state.f, d["f"], "f")
    _assert_close(state.g, d["g"], "g")
    _assert_close(state.vel, d["vel"], "vel")
    _assert_close(state.density, d["den"], "density")


def _float64_states(res):
    """The Rosensweig scene's initial fields in float64, through both
    packages' init with float64 f/g/h storage."""
    jp, js = jscenes.rosensweig_3d(res=res)
    jp = jp.replace(fg_dtype="float64", h_dtype="float64")
    args = [np.array(getattr(js, n), np.float64) for n in ("rho", "density", "vel")]
    args += [np.array(js.flags), np.array(js.magnetic_flags)]
    pp = SimulationParams.from_json(jp.to_json())
    return jp, jmodels.init_ferrofluid_state(jp, *args), pp, init_ferrofluid_state(
        pp, *args, device="cpu")


def test_float64_steps_match_jax():
    jp, js, pp, ps = _float64_states(RES)
    assert ps.f.dtype == ps.h.dtype == ps.rho.dtype == torch.float64
    jpp = jp.replace(use_pallas=False)
    for _ in range(2):
        js = jmodels.ferrofluid_step(jpp, js)
        ps = ferrofluid_step(pp, ps, device="cpu")
    assert ps.h.shape[1] == 19 and ps.h.dtype == torch.float64
    for name in ("f", "g", "density", "vel", "pressure", "h"):
        r = rel(getattr(ps, name), getattr(js, name))
        assert r <= 1e-10, f"{name}: max rel dev {r:.2e}"


def test_channel_state_structure_and_round_trip():
    params, state = rosensweig_3d(res=(6, 8, 10), device="cpu")
    params = params.replace(tau=0.8)
    state = prime_premac(params, state, device="cpu")
    for _ in range(2):
        assert state.premac is not None and len(state.premac) == 6
        assert state.h.shape == (1, 19, 6, 8, 10) and state.cmask is None
        state = ferrofluid_step(params, state, device="cpu")
    fields = to_numpy(state)
    assert fields["cmask"] is None and fields["h"].shape[1] == 19
    back = from_numpy(fields, device="cpu")
    assert back.cmask is None and torch.equal(back.h, state.h)
    assert torch.equal(ferrofluid_step(params, back, device="cpu").h,
                       ferrofluid_step(params, state, device="cpu").h)


@pytest.mark.slow
def test_golden_rosensweig3d_200_plain_float64():
    """tests/test_parity_rosensweig3d.py's configuration and bars through
    the port's plain path: float64 storage, so the channel-form solve."""
    d = np.load(GOLDEN / "rosensweig3d_200.npz")
    params = SimulationParams(
        dim=3, density_gas=0.02381, density_fluid=0.2508, rho_gas=0.02381,
        rho_fluid=0.2508, kappa=0.01, tau_f=0.68, tau_g=0.68,
        gravity=float(d["gravity"]), mag_strength=float(d["mag"]), poisson_iters=30,
        fg_dtype="float64", h_dtype="float64",
    )
    flags = d["flags"]
    res = flags.shape[2:]
    mflags = np.full_like(flags, 2)
    mflags[..., 1:-1, :, 1:-1] = 1
    state = init_ferrofluid_state(
        params, d["rho0"].astype(np.float64), d["den0"].astype(np.float64),
        np.zeros((1, 3, *res), np.float64), flags, mflags, device="cpu",
    )
    runner = SimulationRunner(params, ferrofluid_step, device="cpu")
    state = runner.run(state, 100)
    assert state.h.shape[1] == 19
    np.testing.assert_allclose(state.density.numpy(), d["den_100"], rtol=2e-5, atol=2.5e-6)
    np.testing.assert_allclose(state.vel.numpy(), d["vel_100"], rtol=0, atol=3e-7)
    np.testing.assert_allclose(state.pressure.numpy(), d["p_100"], rtol=2e-5, atol=8e-8)
    state = runner.run(state, int(d["steps"]) - 100)
    np.testing.assert_allclose(state.density.numpy(), d["den_200"], rtol=6e-5, atol=7e-6)
    np.testing.assert_allclose(state.pressure.numpy(), d["p_200"], rtol=5e-5, atol=2e-7)
    np.testing.assert_allclose(state.vel.numpy(), d["vel_200"], rtol=0, atol=1.3e-6)
