"""The port's Rosensweig steady state as a whole, against the JAX package.

* the scene builders give equal initial states;
* from the same numpy init, 3 port steps (prime_premac + steady state,
  float32, plain versions on the CPU) track 3 JAX steps with
  ``use_pallas=False`` at rel <= 2e-5 — the bar of
  tests/test_fastpath_dispatch.py for the same comparison: the port's
  scalar tau == 1 carry and grouped tap order against the channel-form
  solve, both float32, differ at the FMA/reassociation level;
* ``tests/golden/ferro3d.npz`` (the reference solver) is met at the bars
  of tests/test_parity.py:_assert_close;
* the carried structure, the NotImplementedError scope and the launch
  counters (0 on the CPU).

h is compared through the port's own ``compare_views``: the port carries
(s, s_prev) where the JAX run (never primed) carries the 19-channel h.
"""

import dataclasses
import math
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lbm_ferrofluid_tpu import models as jmodels  # noqa: E402
from lbm_ferrofluid_tpu.models import scenes as jscenes  # noqa: E402

from lbm_ferrofluid_tpu_torch.models import (  # noqa: E402
    SimulationParams,
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


_UNSUPPORTED = {
    "2D": (dict(dim=2), "A7"),
    "KBC": (dict(kbc_type=0b10000101), "A7"),
    "bf16 f/g": (dict(fg_dtype="bfloat16"), "A6"),
    "bf16 h": (dict(h_dtype="bfloat16"), "A6"),
    "phys_extent": (dict(phys_extent=(6, 8, 10)), "A8"),
    # the JAX step runs an out-of-plane field only on the padded layout
    "h_ext_axis=2": (dict(h_ext_axis=2), "A8"),
    "tau!=1": (dict(tau=0.8), "B7/B11"),
    "channel form": (dict(scalar_carry=False), "B7/B11"),
}


@pytest.mark.parametrize("case", sorted(_UNSUPPORTED))
def test_unsupported_configs_raise(case):
    params, state = rosensweig_3d(res=(6, 8, 10), device="cpu")
    change, item = _UNSUPPORTED[case]
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        ferrofluid_step(params.replace(**change), state, device="cpu")


def test_batched_state_raises():
    params, state = rosensweig_3d(res=(6, 8, 10), batch=2, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP A12"):
        prime_premac(params, state, device="cpu")


def test_cpu_runs_leave_launch_counters_at_zero():
    from lbm_ferrofluid_tpu_torch.models import SimulationRunner

    kernels.reset_launch_counts()
    params, state = rosensweig_3d(res=(6, 8, 10), device="cpu")
    state = SimulationRunner(params, ferrofluid_step, device="cpu").run(
        state, 2, check_every=1
    )
    assert state.step == 2
    assert kernels.launch_counts(kernels.PATHS["ferrofluid"]) == {
        "B1": 0, "B2": 0, "B3": 0, "B4": 0
    }
    assert all(v == 0 for v in kernels.launch_counts().values())
