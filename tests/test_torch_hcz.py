"""The port's HCZ multiphase slice against the JAX package.

* each new kernel's plain version against its JAX twin in float64, inputs
  from a numpy seed: B8b/B8a (``stream_bounce_macro``/``_moments``) and B9
  (``hcz_collide``) at rel <= 1e-12, the same arithmetic in the same
  order; B2 + B6 (``hcz_capillary``) at rel <= 1e-10, the same formulas
  with the gradients' sums associated differently;
* the three 3D scenes give the JAX builders' params and arrays;
* 3 port steps (plain versions on the CPU, float32) track 3 JAX steps with
  ``use_pallas=False`` at rel <= 2e-5 (the bar of
  tests/test_torch_ferrofluid.py: float32 FMA/reassociation level), for
  ``multiphase_3d`` and ``droplet_spread_3d`` (``hcz_step``) and
  ``two_droplets_3d`` (``ferrofluid_step``), and with velocity pinning;
* a JAX ``HCZState`` carried across as numpy arrays steps as the JAX one;
* ``tests/golden/hcz3d.npz`` (reference solver, 10 steps) is met at the
  bars of tests/test_parity.py.
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
from lbm_ferrofluid_tpu.models import scenes as jscenes  # noqa: E402
from lbm_ferrofluid_tpu.ops import collide as jcollide  # noqa: E402

from lbm_ferrofluid_tpu_torch.models import (  # noqa: E402
    HCZState,
    SimulationParams,
    SimulationRunner,
    droplet_spread_3d,
    ferrofluid_step,
    from_numpy,
    hcz_step,
    init_hcz_state,
    multiphase_3d,
    prime_premac,
    to_numpy,
    two_droplets_3d,
)
from lbm_ferrofluid_tpu_torch.ops import collide as pcollide  # noqa: E402
from lbm_ferrofluid_tpu_torch.ops import kernels  # noqa: E402
from lbm_ferrofluid_tpu_torch.ops.scalar_poisson import compare_views  # noqa: E402

# ops/__init__ re-exports the function ``stream`` over the module's name
jstream = importlib.import_module("lbm_ferrofluid_tpu.ops.stream")

GOLDEN = pathlib.Path(__file__).parent / "golden"
OBS, FLUID = 2, 1
RG, RF = 0.02381, 0.2508
GAS = dict(rho_gas=RG, rho_fluid=RF, density_gas=RG, density_fluid=RF)
RES = [(6, 8, 10), (10, 12, 14)]
ANGLE = 0.75 * math.pi  # the HCZ scenes' contact angle


def rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def T(x):
    return torch.from_numpy(np.array(x))


def _fields(res, seed):
    """Seeded float64 fields: an obstacle frame plus an interior obstacle
    block, near-equilibrium f and g."""
    rng = np.random.default_rng(seed)
    Z, Y, X = res
    fl = np.full((1, 1, *res), OBS, np.uint8)
    fl[..., 1:-1, 1:-1, 1:-1] = FLUID
    fl[..., Z // 2, Y // 2, 2:4] = OBS
    rho = RG + (RF - RG) * rng.uniform(0.0, 1.0, (1, 1, *res))
    w = JD3Q19.w_bcast(np.float64)
    return dict(
        flags=fl, rho=rho,
        den=RG + (RF - RG) * rng.uniform(0.0, 1.0, (1, 1, *res)),
        pres=rng.uniform(0.01, 0.03, (1, 1, *res)),
        vel=rng.uniform(-0.02, 0.02, (1, 3, *res)),
        f=w * rho * (1.0 + 0.1 * rng.standard_normal((1, 19, *res))),
        g=w * 0.02 * (1.0 + 0.1 * rng.standard_normal((1, 19, *res))),
        H2=1e4 * rng.uniform(0.9, 1.1, (1, 1, *res)),
        phi=rng.uniform(-1.2, 1.2, (1, 1, *res)),
        gsum=rng.uniform(0.01, 0.03, (1, 1, *res)),
        gmom=rng.uniform(-1e-3, 1e-3, (1, 3, *res)),
        force=rng.uniform(-1e-4, 1e-4, (1, 3, *res)),
        dfai=rng.uniform(-1e-3, 1e-3, (1, 3, *res)),
        dprho=rng.uniform(-1e-3, 1e-3, (1, 3, *res)),
    )


# ---------------------------------------------------------------- B8b, B8a
@pytest.mark.parametrize("res", RES)
def test_stream_macro_plain_matches_jax(res):
    d = _fields(res, 1)
    want = jstream.stream_bounce_macro(
        JD3Q19, jnp.asarray(d["f"]), jnp.asarray(d["flags"]), jnp.asarray(d["rho"]),
        jnp.asarray(d["vel"]), c=1.0, use_pallas=False, **GAS,
    )
    got = kernels.stream_bounce_macro_plain(
        T(d["f"]), T(d["flags"]), T(d["rho"]), T(d["vel"]), c=1.0, **GAS
    )
    for name, a, b in zip(("f_post", "rho", "vel", "density"), got, want, strict=True):
        assert rel(a, b) <= 1e-12, name


@pytest.mark.parametrize("res", RES)
def test_stream_moments_plain_matches_jax(res):
    d = _fields(res, 2)
    want = jstream.stream_bounce_moments(
        JD3Q19, jnp.asarray(d["g"]), jnp.asarray(d["flags"]), use_pallas=False
    )
    got = kernels.stream_bounce_moments_plain(T(d["g"]), T(d["flags"]))
    for name, a, b in zip(("g_post", "m0", "m1"), got, want, strict=True):
        assert rel(a, b) <= 1e-12, name


# ---------------------------------------------------------------- B2 + B6
@pytest.mark.parametrize("variant", ["no_kelvin", "kelvin", "moments_from_g"])
@pytest.mark.parametrize("res", RES)
def test_capillary_plain_matches_jax(res, variant):
    """B2 then B6's plain version against the JAX ``hcz_capillary``, which
    runs the contact angle itself: all seven outputs."""
    d = _fields(res, 3)
    J = {k: jnp.asarray(v) for k, v in d.items()}
    grav = (0.0, float(np.float32(-1e-5)), 0.0)
    kelvin = variant == "kelvin"
    given = variant != "moments_from_g"
    g_post = jstream.bounce_back(JD3Q19, jstream.stream(JD3Q19, J["g"]), J["flags"])
    want = jcollide.hcz_capillary(
        JD3Q19, J["rho"], J["vel"], J["flags"], g_post, J["den"], J["pres"],
        kappa=0.1, gravity=jnp.asarray(grav).reshape(1, 3, 1, 1, 1), contact_angle=ANGLE,
        dx=1.0, dt=1.0, H2=J["H2"] if kelvin else None, phi=J["phi"] if kelvin else None,
        g_sum=J["gsum"] if given else None, g_mom=J["gmom"] if given else None,
        use_pallas=False, **GAS,
    )
    rho_ca = kernels.contact_angle_3d_plain(T(d["rho"]), T(d["flags"]), ANGLE)
    kw = dict(kappa=0.1, gravity=grav, dx=1.0, dt=1.0, **GAS)
    H2, phi = (T(d["H2"]), T(d["phi"])) if kelvin else (None, None)
    if given:
        out = kernels.hcz_capillary_gradmac_plain(
            T(d["rho"]), T(d["den"]), T(d["pres"]), rho_ca, H2, phi, T(d["flags"]),
            T(d["gsum"]), T(d["gmom"]), T(d["vel"]), **kw,
        )
        got = (rho_ca, out[0], pcollide.rho_to_density(rho_ca, **GAS)) + out[1:]
    else:
        kw["gravity"] = torch.tensor(grav, dtype=torch.float64).reshape(1, 3, 1, 1, 1)
        got = pcollide.hcz_capillary(
            T(d["rho"]), T(d["vel"]), T(d["flags"]), T(d["den"]), T(d["pres"]), rho_ca,
            g=T(np.asarray(g_post)), **kw,
        )
    names = ("rho", "vel", "density", "pressure", "force", "dfai", "dprho")
    for name, a, b in zip(names, got, want, strict=True):
        assert rel(a, b) <= 1e-10, f"{name}: {rel(a, b):.2e}"


def test_capillary_needs_h2_and_phi_together():
    d = {k: T(v) for k, v in _fields((6, 8, 10), 4).items()}
    with pytest.raises(ValueError, match="together"):
        pcollide.hcz_capillary(
            d["rho"], d["vel"], d["flags"], d["den"], d["pres"], d["rho"], d["H2"], None,
            d["gsum"], d["gmom"], kappa=0.1, gravity=torch.zeros(1, 3, 1, 1, 1), **GAS,
        )


# ---------------------------------------------------------------- B9
@pytest.mark.parametrize("res", RES)
def test_collide_plain_matches_jax(res):
    d = _fields(res, 5)
    names = ("f", "g", "rho", "vel", "den", "pres", "flags", "force", "dfai", "dprho")
    want = jcollide.hcz_collide(
        JD3Q19, *(jnp.asarray(d[n]) for n in names), tau_f=0.7, tau_g=0.7,
        use_pallas=False,
    )
    got = kernels.hcz_collide_fused_plain(*(T(d[n]) for n in names), tau_f=0.7, tau_g=0.7)
    for name, a, b in zip(("f", "g"), got, want, strict=True):
        assert rel(a, b) <= 1e-12, name
    # non-fluid cells keep their streamed values
    keep = d["flags"][0, 0] != FLUID
    np.testing.assert_array_equal(got[0].numpy()[0][:, keep], d["f"][0][:, keep])


def test_new_wrappers_take_the_plain_version_on_cpu():
    d = {k: T(v).float() if v.dtype == np.float64 else T(v)
         for k, v in _fields((6, 8, 10), 6).items()}
    pairs = [
        (kernels.stream_bounce_moments, kernels.stream_bounce_moments_plain,
         (d["f"], d["flags"]), {}),
        (kernels.stream_bounce_macro, kernels.stream_bounce_macro_plain,
         (d["f"], d["flags"], d["rho"], d["vel"]), dict(c=1.0, **GAS)),
        (kernels.hcz_capillary_gradmac, kernels.hcz_capillary_gradmac_plain,
         (d["rho"], d["den"], d["pres"], d["rho"], None, None, d["flags"], d["gsum"],
          d["gmom"], d["vel"]), dict(kappa=0.1, gravity=(0.0, -1e-5, 0.0), **GAS)),
        (kernels.hcz_collide_fused, kernels.hcz_collide_fused_plain,
         (d["f"], d["g"], d["rho"], d["vel"], d["den"], d["pres"], d["flags"], d["force"],
          d["dfai"], d["dprho"]), dict(tau_f=0.7, tau_g=0.7)),
    ]
    kernels.reset_launch_counts()
    for wrapper, plain, args, kw in pairs:
        for a, b in zip(wrapper(*args, **kw), plain(*args, **kw), strict=True):
            assert torch.equal(a, b), wrapper.__name__
    assert all(v == 0 for v in kernels.launch_counts().values())


# ---------------------------------------------------------------- scenes
SCENES = {
    "multiphase_3d": (jscenes.multiphase_3d, multiphase_3d, (8, 10, 12)),
    "droplet_spread_3d": (jscenes.droplet_spread_3d, droplet_spread_3d, (8, 10, 12)),
    "two_droplets_3d": (jscenes.two_droplets_3d, two_droplets_3d, (6, 8, 14)),
}


def _jax_fields(state):
    """A JAX state as numpy arrays keyed by field name (None/tuples kept)."""
    def conv(v):
        if v is None:
            return None
        if isinstance(v, tuple):
            return tuple(conv(x) for x in v)
        return np.asarray(v)
    return {f.name: conv(getattr(state, f.name)) for f in dataclasses.fields(state)}


@pytest.mark.parametrize("name", sorted(SCENES))
def test_scene_matches_jax(name):
    jbuild, pbuild, res = SCENES[name]
    jp, js = jbuild(res=res)
    pp, ps = pbuild(res=res, device="cpu")
    assert pp.to_json() == jp.to_json()
    assert type(ps).__name__ == type(js).__name__
    for fld in dataclasses.fields(js):
        a, b = getattr(ps, fld.name), getattr(js, fld.name)
        if fld.name in ("f", "g"):
            assert rel(a, b) <= 1e-6, fld.name
        elif fld.name == "step":
            assert a == int(b) == 0
        elif isinstance(b, tuple):
            for x, y in zip(a, b, strict=True):
                np.testing.assert_array_equal(x.numpy(), np.asarray(y))
        elif b is None:
            assert a is None, fld.name
        else:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-9,
                                       err_msg=fld.name)


# ---------------------------------------------------------------- the slice
def _port_and_jax_steps(jp, js, n, port_step, pin=None):
    """``n`` JAX steps (``use_pallas=False``) and ``n`` port steps from the
    same state, carried across as numpy arrays."""
    if pin is not None:
        js = dataclasses.replace(js, vel_pin_mask=jnp.asarray(pin[0]),
                                 vel_pin_value=jnp.asarray(pin[1]))
    pp = SimulationParams.from_json(jp.to_json())
    ps = from_numpy(_jax_fields(js), device="cpu")
    jstep = jmodels.hcz_step if isinstance(ps, HCZState) else jmodels.ferrofluid_step
    jpp = jp.replace(use_pallas=False)
    start = ps.step
    for _ in range(n):
        js = jstep(jpp, js)
    for _ in range(n):
        ps = port_step(pp, ps, device="cpu")
    assert ps.step == int(js.step) == start + n
    return ps, js


@pytest.mark.parametrize("name", ["multiphase_3d", "droplet_spread_3d"])
def test_three_hcz_steps_match_jax_step(name):
    jbuild, _, res = SCENES[name]
    ps, js = _port_and_jax_steps(*jbuild(res=res), 3, hcz_step)
    for fld in ("f", "g", "rho", "density", "vel", "pressure", "force"):
        r = rel(getattr(ps, fld), getattr(js, fld))
        assert r <= 2e-5, f"{fld}: max rel dev {r:.2e}"


def test_three_two_droplets_steps_match_jax_step():
    jp, js = jscenes.two_droplets_3d(res=SCENES["two_droplets_3d"][2])

    def carried_step(params, state, device):
        # the carried steady state with the scalar carry: prime once
        return ferrofluid_step(params, prime_premac(params, state, device=device),
                               device=device)

    ps, js = _port_and_jax_steps(jp, js, 3, carried_step)
    assert len(ps.premac) == 6 and ps.h.shape[1] == 2
    for fld in ("f", "g", "density", "vel", "pressure"):
        r = rel(getattr(ps, fld), getattr(js, fld))
        assert r <= 2e-5, f"{fld}: max rel dev {r:.2e}"
    a, b = compare_views(ps.h, T(js.h), ps.magnetic_flags)
    assert rel(a, b) <= 2e-5


def test_velocity_pinning_matches_jax_step():
    """A pinned inflow plane (the wave demo's idiom, scenes.py:146-150): the
    pin applies after the streamed macros and after the capillary stage."""
    jp, js = jscenes.multiphase_3d(res=(8, 10, 12))
    mask = np.zeros((1, 3, 8, 10, 12), bool)
    mask[:, 0, :, :, 1] = True
    value = np.where(mask, np.float32(0.05), np.float32(0.0)).astype(np.float32)
    ps, js = _port_and_jax_steps(jp, js, 3, hcz_step, pin=(mask, value))
    for fld in ("f", "g", "density", "vel", "pressure"):
        r = rel(getattr(ps, fld), getattr(js, fld))
        assert r <= 2e-5, f"{fld}: max rel dev {r:.2e}"
    np.testing.assert_array_equal(ps.vel.numpy()[mask], value[mask])


def test_jax_state_carried_across_steps_as_jax():
    """A JAX HCZState two steps in (pressure and force no longer at their
    init values) becomes a port state through numpy, and both take the
    same next step; the port state round-trips through numpy unchanged."""
    jp, js = jscenes.droplet_spread_3d(res=(8, 10, 12))
    jpp = jp.replace(use_pallas=False)
    for _ in range(2):
        js = jmodels.hcz_step(jpp, js)
    fields = _jax_fields(js)
    ps = from_numpy(fields, device="cpu")
    assert isinstance(ps, HCZState) and ps.step == 2
    back = to_numpy(ps)
    assert set(back) == set(fields)
    for k, v in fields.items():
        if v is not None:
            np.testing.assert_array_equal(back[k], v, err_msg=k)
    ps, js = _port_and_jax_steps(jp, js, 1, hcz_step)
    for fld in ("f", "g", "density", "vel", "pressure", "force"):
        assert rel(getattr(ps, fld), getattr(js, fld)) <= 2e-5, fld


def _assert_close(got, want, name, atol=2e-5, rtol=2e-4):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    err = np.abs(got - want).max()
    scale = np.abs(want).max() + 1e-30
    assert err <= atol + rtol * scale, f"{name}: max|err|={err:.3e} scale={scale:.3e}"


def hcz3d_params():
    """tests/test_parity.py:test_hcz3d_parity's configuration."""
    return SimulationParams(
        dim=3, density_gas=0.02381, density_fluid=0.2508, rho_gas=0.02381,
        rho_fluid=0.2508, kappa=0.01, tau_f=0.68, tau_g=0.68, gravity=1e-4,
        contact_angle=0.5 * math.pi,
    )


def test_golden_hcz3d():
    d = np.load(GOLDEN / "hcz3d.npz")
    res = d["rho0"].shape[2:]
    state = init_hcz_state(hcz3d_params(), d["rho0"], d["den0"],
                           np.zeros((1, 3, *res), np.float32), d["flags"], device="cpu")
    _assert_close(state.f, d["f0"], "f_init", atol=1e-6)
    _assert_close(state.g, d["g0"], "g_init", atol=1e-6)
    state = SimulationRunner(hcz3d_params(), hcz_step, device="cpu").run(state, 10)
    for name, got in (("f", state.f), ("g", state.g), ("vel", state.vel),
                      ("den", state.density)):
        _assert_close(got, d[name], name)


#: configuration -> (change, what the message names): its ROADMAP item, or,
#: for a storage dtype the JAX package has no mode for, the dtype; 2D params
#: on this 3D state and KBC on D3Q19 raise ``ValueError`` (the KBC message is
#: the JAX package's own), the rest ``NotImplementedError``
_UNSUPPORTED = {
    "2D": (dict(dim=2), "params.dim=2 .D2Q9. does not match the state"),
    "KBC": (dict(kbc_type=0b10000101), "D2Q9 only"),
    "float16 f/g": (dict(fg_dtype="float16"), "'float16'.*no float16 mode"),
    "phys_extent": (dict(phys_extent=(6, 8, 10)), "ROADMAP A8"),
}


@pytest.mark.parametrize("case", sorted(_UNSUPPORTED))
def test_unsupported_hcz_configs_raise(case):
    params, state = multiphase_3d(res=(6, 8, 10), device="cpu")
    change, names = _UNSUPPORTED[case]
    error = ValueError if case in ("2D", "KBC") else NotImplementedError
    with pytest.raises(error, match=names):
        hcz_step(params.replace(**change), state, device="cpu")


def test_batched_hcz_state_raises():
    params, state = multiphase_3d(res=(6, 8, 10), batch=2, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP A12"):
        hcz_step(params, state, device="cpu")


def test_cpu_hcz_runs_leave_launch_counters_at_zero():
    kernels.reset_launch_counts()
    params, state = droplet_spread_3d(res=(6, 8, 10), device="cpu")
    runner = SimulationRunner(params, hcz_step, device="cpu")
    assert runner.prepare(state) is state  # nothing to prime
    state = runner.run(state, 2, check_every=1)
    assert state.step == 2
    assert set(kernels.PATHS["hcz"]) <= set(kernels.KERNELS)
    assert all(v == 0 for v in kernels.launch_counts().values())


def test_two_droplets_primes_on_the_ferrofluid_path():
    params, state = two_droplets_3d(res=(6, 8, 14), device="cpu")
    state = prime_premac(params, state, device="cpu")
    assert state.premac is not None and state.h.shape[1] == 2
