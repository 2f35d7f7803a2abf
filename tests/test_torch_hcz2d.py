"""The port's 2D HCZ model against the JAX package.

* each new op against its JAX twin in float64, inputs from a numpy seed:
  the 2D stencils (``isotropic_grad`` with its obstacle substitution,
  ``isotropic_laplacian`` with the reference's /5, ``staggered``) at rel <=
  1e-10 (sums that the two packages may associate differently); the 2D
  contact angle bit for bit (a chain of in-place updates, faces then the
  corners one after another, the last averaging rho[-2, -2] with itself);
  the 2D capillary stage (``hcz_capillary``, without and with the Kelvin
  force, with the g moments given or taken from g) at rel <= 1e-10, its
  gradients' sums associated differently; the 2D ``hcz_collide`` (LBGK and
  KBC A-D on g) at rel <= 1e-12, the same arithmetic in the same order;
* ``multiphase_drop_hcz``, ``wave`` and ``droplet_spread_2d`` give the JAX
  builders' params and arrays (``wave`` with its velocity pin);
* 3 port steps (float32, CPU) against 3 JAX steps at rel <= 2e-5 (the bar
  of tests/test_torch_ferrofluid.py) on each scene, ``wave`` with pinning;
* ``tests/golden/hcz.npz`` and ``hcz_kbc_wetting.npz`` (reference solver,
  20 steps) at the bars of tests/test_parity.py;
* a JAX 2D ``HCZState`` (with pins) given to ``from_numpy`` steps as the
  JAX one; bfloat16 f/g storage in 2D; the guards on params that do not
  match the state; the CPU launches no kernel.

``wave`` (KBC_A on g from a state at equilibrium) is held against the JAX
package's eager step body ``hcz_step_impl``: the entropic estimator's
denominator sits at float32 noise level in most cells there, and XLA's
fusion under ``jit`` evaluates it in another order, so the JAX package's
own jitted and eager steps lie 3.0e-5 apart in g and 4.4e-5 in vel after 3
steps (measured), while the port's step equals the eager body bit for bit
(:func:`test_wave_steps_equal_the_eager_jax_step`).  In float64 the port
meets the jitted step at 1e-12 (:func:`test_three_float64_steps_match_jax`).
"""

import dataclasses
import math
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lbm_ferrofluid_tpu import models as jmodels  # noqa: E402
from lbm_ferrofluid_tpu.lattice import D2Q9 as JD2Q9  # noqa: E402
from lbm_ferrofluid_tpu.models import multiphase as jmultiphase  # noqa: E402
from lbm_ferrofluid_tpu.models import scenes as jscenes  # noqa: E402
from lbm_ferrofluid_tpu.ops import collide as jcollide  # noqa: E402
from lbm_ferrofluid_tpu.ops import stencils as jstencils  # noqa: E402
from lbm_ferrofluid_tpu.ops.stream import bounce_back as jbounce  # noqa: E402
from lbm_ferrofluid_tpu.ops.stream import stream as jstream  # noqa: E402

from lbm_ferrofluid_tpu_torch.lattice import D2Q9  # noqa: E402
from lbm_ferrofluid_tpu_torch.models import (  # noqa: E402
    HCZState,
    SimulationParams,
    SimulationRunner,
    droplet_spread_2d,
    from_numpy,
    hcz_step,
    init_hcz_state,
    multiphase_3d,
    multiphase_drop_hcz,
    wave,
)
from lbm_ferrofluid_tpu_torch.ops import collide as pcollide  # noqa: E402
from lbm_ferrofluid_tpu_torch.ops import kernels  # noqa: E402
from lbm_ferrofluid_tpu_torch.ops import stencils as pstencils  # noqa: E402

GOLDEN = pathlib.Path(__file__).parent / "golden"
OBS, FLUID = 2, 1
RG, RF = 0.02381, 0.2508
GAS = dict(rho_gas=RG, rho_fluid=RF, density_gas=RG, density_fluid=RF)
RES = (24, 20)
KBC = {"A": 0b10000101, "B": 0b10000110, "C": 0b10001001, "D": 0b10001010}


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


def _fields(seed, res=RES):
    """Seeded float64 2D fields: an obstacle frame plus an interior obstacle
    pair, near-equilibrium f and g."""
    rng = np.random.default_rng(seed)
    H, W = res
    fl = np.full((1, 1, *res), OBS, np.uint8)
    fl[..., 1:-1, 1:-1] = FLUID
    fl[..., H // 2, 3:5] = OBS
    rho = RG + (RF - RG) * rng.uniform(0.0, 1.0, (1, 1, *res))
    w = JD2Q9.w_bcast(np.float64)
    return dict(
        flags=fl, rho=rho,
        den=RG + (RF - RG) * rng.uniform(0.0, 1.0, (1, 1, *res)),
        pres=rng.uniform(0.01, 0.03, (1, 1, *res)),
        vel=rng.uniform(-0.02, 0.02, (1, 2, *res)),
        f=w * rho * (1.0 + 0.1 * rng.standard_normal((1, 9, *res))),
        g=w * 0.02 * (1.0 + 0.1 * rng.standard_normal((1, 9, *res))),
        H2=1e4 * rng.uniform(0.9, 1.1, (1, 1, *res)),
        phi=rng.uniform(-1.2, 1.2, (1, 1, *res)),
        gsum=rng.uniform(0.01, 0.03, (1, 1, *res)),
        gmom=rng.uniform(-1e-3, 1e-3, (1, 2, *res)),
        force=rng.uniform(-1e-4, 1e-4, (1, 2, *res)),
        dfai=rng.uniform(-1e-3, 1e-3, (1, 2, *res)),
        dprho=rng.uniform(-1e-3, 1e-3, (1, 2, *res)),
    )


# ---------------------------------------------------------------- ops, float64
@pytest.mark.parametrize("op", ["grad", "laplacian", "staggered"])
def test_stencils_2d_match_jax(op):
    d = _fields(1)
    x, fl = d["rho"], d["flags"]
    if op == "grad":
        want = [jstencils.isotropic_grad(jnp.asarray(x), 1.0, jnp.asarray(fl), 2)]
        got = [pstencils.isotropic_grad(T(x), 1.0, T(fl))]
    elif op == "laplacian":
        want = [jstencils.isotropic_laplacian(jnp.asarray(x), 1.0, 2)]
        got = [pstencils.isotropic_laplacian(T(x), 1.0)]
    else:
        want = jstencils.staggered(jnp.asarray(d["vel"]))
        got = pstencils.staggered(T(d["vel"]))
    assert len(got) == len(want)
    for a, b in zip(got, want, strict=True):
        assert tuple(a.shape) == tuple(b.shape)
        assert rel(a, b) <= 1e-10


@pytest.mark.parametrize("angle", [0.5, 0.75, 0.55, 0.3])
def test_contact_angle_2d_matches_jax_bit_for_bit(angle):
    d = _fields(2)
    want = np.asarray(jcollide.contact_angle_boundary(
        jnp.asarray(d["rho"]), jnp.asarray(d["flags"]), angle * math.pi, 2, spmd=False))
    got = pcollide.contact_angle_boundary(T(d["rho"]), T(d["flags"]), angle * math.pi)
    np.testing.assert_array_equal(got.numpy(), want)
    # the reference's corner quirk: rho[-1, -1] is rho[-2, -2]
    assert got[0, 0, -1, -1] == got[0, 0, -2, -2]
    assert not np.array_equal(got.numpy(), d["rho"])


@pytest.mark.parametrize("variant", ["no_kelvin", "kelvin", "moments_from_g"])
def test_capillary_2d_matches_jax(variant):
    """The 2D contact angle then ``hcz_capillary`` against the JAX
    ``hcz_capillary``, which runs the contact angle itself: all seven
    outputs."""
    d = _fields(3)
    J = {k: jnp.asarray(v) for k, v in d.items()}
    grav = np.zeros((1, 2, 1, 1))
    grav[0, 1] = float(np.float32(-1e-4))
    kelvin = variant == "kelvin"
    given = variant != "moments_from_g"
    g_post = jbounce(JD2Q9, jstream(JD2Q9, J["g"]), J["flags"])
    want = jcollide.hcz_capillary(
        JD2Q9, J["rho"], J["vel"], J["flags"], g_post, J["den"], J["pres"], kappa=0.1,
        gravity=jnp.asarray(grav), contact_angle=0.75 * math.pi, dx=1.0, dt=1.0,
        H2=J["H2"] if kelvin else None, phi=J["phi"] if kelvin else None,
        g_sum=J["gsum"] if given else None, g_mom=J["gmom"] if given else None,
        use_pallas=False, **GAS,
    )
    rho_ca = pcollide.contact_angle_boundary(T(d["rho"]), T(d["flags"]), 0.75 * math.pi)
    got = pcollide.hcz_capillary(
        T(d["rho"]), T(d["vel"]), T(d["flags"]), T(d["den"]), T(d["pres"]), rho_ca,
        T(d["H2"]) if kelvin else None, T(d["phi"]) if kelvin else None,
        T(d["gsum"]) if given else None, T(d["gmom"]) if given else None,
        g=T(np.asarray(g_post)), kappa=0.1, gravity=T(grav), **GAS,
    )
    names = ("rho", "vel", "density", "pressure", "force", "dfai", "dprho")
    for name, a, b in zip(names, got, want, strict=True):
        assert rel(a, b) <= 1e-10, name


@pytest.mark.parametrize("variant", ["LBGK", "A", "B", "C", "D"])
def test_collide_2d_matches_jax(variant):
    d = _fields(4)
    kbc = KBC.get(variant)
    keys = ("f", "g", "rho", "vel", "den", "pres", "flags", "force", "dfai", "dprho")
    want = jcollide.hcz_collide(JD2Q9, *(jnp.asarray(d[k]) for k in keys), tau_f=0.7,
                                tau_g=0.8, kbc_type=kbc, use_pallas=False)
    got = pcollide.hcz_collide(D2Q9, *(T(d[k]) for k in keys), tau_f=0.7, tau_g=0.8,
                               kbc_type=kbc)
    for name, a, b in zip(("f", "g"), got, want, strict=True):
        assert rel(a, b) <= 1e-12, name


# ---------------------------------------------------------------- scenes and steps
SCENES = {
    "multiphase_drop_hcz": (jscenes.multiphase_drop_hcz, multiphase_drop_hcz),
    "wave": (jscenes.wave, wave),
    "droplet_spread_2d": (jscenes.droplet_spread_2d, droplet_spread_2d),
}
SMALL = (20, 24)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_scene_matches_jax(name):
    jbuild, pbuild = SCENES[name]
    jp, js = jbuild(res=SMALL)
    pp, ps = pbuild(res=SMALL, device="cpu")
    assert pp.to_json() == jp.to_json()
    for fld in dataclasses.fields(js):
        a, b = getattr(ps, fld.name), getattr(js, fld.name)
        if fld.name in ("f", "g"):
            assert rel(a, b) <= 1e-6, fld.name
        elif fld.name == "step":
            assert a == int(b) == 0
        elif b is None:
            assert a is None, fld.name
        else:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-9,
                                       err_msg=fld.name)


def _steps(jp, js, n, jstep=None):
    """``n`` JAX steps (``jstep``, default the jitted ``hcz_step``) and ``n``
    port steps from the same state, carried across as numpy arrays."""
    jstep = jstep or jmodels.hcz_step
    pp = SimulationParams.from_json(jp.to_json())
    ps = from_numpy(_jax_fields(js), device="cpu")
    start = ps.step
    for _ in range(n):
        js = jstep(jp, js)
        ps = hcz_step(pp, ps, device="cpu")
    assert ps.step == int(js.step) == start + n
    return ps, js


FIELDS = ("f", "g", "rho", "vel", "density", "pressure", "force")


@pytest.mark.parametrize("name", sorted(SCENES))
def test_three_steps_match_jax_step(name):
    jstep = jmultiphase.hcz_step_impl if name == "wave" else None
    ps, js = _steps(*SCENES[name][0](res=SMALL), 3, jstep)
    for fld in FIELDS:
        r = rel(getattr(ps, fld), getattr(js, fld))
        assert r <= 2e-5, f"{fld}: max rel dev {r:.2e}"
    if name == "wave":
        mask = ps.vel_pin_mask.numpy()
        np.testing.assert_array_equal(ps.vel.numpy()[mask], ps.vel_pin_value.numpy()[mask])


def test_wave_steps_equal_the_eager_jax_step():
    """The port's float32 wave steps equal the JAX package's eager step body
    bit for bit; the jitted JAX step lies further from that body than the
    2e-5 bar (XLA's fused evaluation of the KBC estimator)."""
    ps, js = _steps(*jscenes.wave(res=SMALL), 3, jmultiphase.hcz_step_impl)
    for fld in FIELDS:
        np.testing.assert_array_equal(getattr(ps, fld).numpy(), np.asarray(getattr(js, fld)),
                                      err_msg=fld)
    jp, jj = jscenes.wave(res=SMALL)
    for _ in range(3):
        jj = jmodels.hcz_step(jp, jj)
    assert rel(jj.g, js.g) > 2e-5


def _to64(state):
    kw = {f.name: getattr(state, f.name).astype(jnp.float64) for f in dataclasses.fields(state)
          if f.name in ("f", "g", "rho", "vel", "density", "pressure", "force",
                        "vel_pin_value") and getattr(state, f.name) is not None}
    return dataclasses.replace(state, **kw)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_three_float64_steps_match_jax(name):
    jp, js = SCENES[name][0](res=SMALL)
    ps, js = _steps(jp.replace(fg_dtype="float64"), _to64(js), 3)
    assert ps.f.dtype == torch.float64
    for fld in FIELDS:
        r = rel(getattr(ps, fld), getattr(js, fld))
        assert r <= 1e-12, f"{fld}: max rel dev {r:.2e}"


def _assert_close(got, want, name, atol=2e-5, rtol=2e-4):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    err = np.abs(got - want).max()
    scale = np.abs(want).max() + 1e-30
    assert err <= atol + rtol * scale, f"{name}: max|err|={err:.3e} scale={scale:.3e}"


def hcz2d_params(**kw):
    """tests/test_parity.py:_hcz_params."""
    base = dict(dim=2, kappa=0.08, tau_f=0.7, tau_g=0.8, contact_angle=0.5 * math.pi, **GAS)
    base.update(kw)
    return SimulationParams(**base)


@pytest.mark.parametrize("name", ["hcz", "hcz_kbc_wetting"])
def test_golden_hcz2d(name):
    """tests/test_parity.py:test_hcz_parity and test_hcz_kbc_wetting_parity
    through the port."""
    d = np.load(GOLDEN / f"{name}.npz")
    params = hcz2d_params()
    if name == "hcz_kbc_wetting":
        params = hcz2d_params(kbc_type=KBC["A"], gravity=1e-4, contact_angle=0.75 * math.pi)
    state = init_hcz_state(params, d["rho0"], d["den0"], np.zeros((1, 2, *RES), np.float32),
                           d["flags"], device="cpu")
    if name == "hcz":
        _assert_close(state.f, d["f0"], "f_init", atol=1e-6)
        _assert_close(state.g, d["g0"], "g_init", atol=1e-6)
        _assert_close(state.pressure, d["p0"], "p_init", atol=1e-6)
    state = SimulationRunner(params, hcz_step, device="cpu").run(state, 20)
    pairs = [("f", "f"), ("g", "g"), ("vel", "vel"), ("density", "den")]
    if name == "hcz":
        pairs += [("rho", "rho"), ("pressure", "p")]
    for attr, key in pairs:
        _assert_close(getattr(state, attr), d[key], attr)


def test_jax_state_carried_across_steps_as_jax():
    jp, js = jscenes.droplet_spread_2d(res=SMALL)
    for _ in range(2):
        js = jmodels.hcz_step(jp, js)
    ps = from_numpy(_jax_fields(js), device="cpu")
    assert isinstance(ps, HCZState) and ps.step == 2 and ps.f.shape[1] == 9
    ps, js = _steps(jp, js, 1)
    for fld in FIELDS:
        assert rel(getattr(ps, fld), getattr(js, fld)) <= 2e-5, fld


def test_bf16_storage_2d():
    """``init_hcz_state`` rounds f and g to ``fg_dtype`` in 2D as in 3D; the
    bfloat16 step keeps the storage and tracks the JAX package's bfloat16
    step at a quarter of JAX's own bfloat16-vs-float32 distance in density,
    rho and vel (the bar of tests/test_torch_bf16_slice.py): both compute in
    float32 and round where they store, and f and g stay within one
    bfloat16 ulp (2**-8 relative) of JAX's."""
    jp, js32 = jscenes.multiphase_drop_hcz(res=SMALL)
    jp16 = jp.replace(fg_dtype="bfloat16")
    js = jscenes.multiphase_drop_hcz(res=SMALL)[1]
    js = dataclasses.replace(js, f=js.f.astype(jnp.bfloat16), g=js.g.astype(jnp.bfloat16))
    pp, ps0 = multiphase_drop_hcz(res=SMALL, device="cpu")
    ps0 = init_hcz_state(pp.replace(fg_dtype="bfloat16"), ps0.rho, ps0.density, ps0.vel,
                         ps0.flags, device="cpu")
    assert ps0.f.dtype == ps0.g.dtype == torch.bfloat16
    np.testing.assert_array_equal(ps0.f.float().numpy(), np.asarray(js.f, np.float32))
    np.testing.assert_array_equal(ps0.g.float().numpy(), np.asarray(js.g, np.float32))
    ps, js = _steps(jp16, js, 3)
    for _ in range(3):
        js32 = jmodels.hcz_step(jp, js32)
    assert ps.f.dtype == ps.g.dtype == torch.bfloat16
    for fld in ("f", "g"):
        assert rel(getattr(ps, fld).float(), np.asarray(getattr(js, fld), np.float32)) <= 2**-8
    for fld in ("density", "rho", "vel"):
        port = np.abs(getattr(ps, fld).double().numpy()
                      - np.asarray(getattr(js, fld), np.float64)).max()
        own = np.abs(np.asarray(getattr(js, fld), np.float64)
                     - np.asarray(getattr(js32, fld), np.float64)).max()
        assert 0 < own and port <= 0.25 * own, f"{fld}: port {port:.3e}, JAX own {own:.3e}"


def test_params_that_do_not_match_the_state_raise():
    p3, s3 = multiphase_3d(res=(6, 8, 10), device="cpu")
    p2, s2 = multiphase_drop_hcz(res=(10, 12), device="cpu")
    with pytest.raises(ValueError, match="params.dim=2"):
        hcz_step(p2, s3, device="cpu")
    with pytest.raises(ValueError, match="params.dim=3"):
        hcz_step(p3, s2, device="cpu")


def test_cpu_runs_leave_launch_counters_at_zero():
    kernels.reset_launch_counts()
    for build in (multiphase_drop_hcz, wave, droplet_spread_2d):
        params, state = build(res=(10, 12), device="cpu")
        state = SimulationRunner(params, hcz_step, device="cpu").run(state, 2, check_every=1)
        assert state.step == 2
    assert all(v == 0 for v in kernels.launch_counts().values())


NATIVE = {
    "shear_layer": (jscenes.shear_layer, {}, "singlephase_step"),
    "shear_layer_kbc": (jscenes.shear_layer, {"kbc": True}, "singlephase_step"),
    "multiphase_drop_sc": (jscenes.multiphase_drop_sc, {}, "sc_step"),
    "multiphase_drop_hcz": (jscenes.multiphase_drop_hcz, {}, "hcz_step"),
    "wave": (jscenes.wave, {}, "hcz_step"),
    "droplet_spread_2d": (jscenes.droplet_spread_2d, {}, "hcz_step"),
    "two_droplets_2d": (jscenes.two_droplets_2d, {}, "ferrofluid_step"),
    "rosensweig_2d": (jscenes.rosensweig_2d, {}, "ferrofluid_step"),
}


def _summed_rho(state):
    rho = np.asarray(state.rho, np.float64)
    if hasattr(state, "density"):
        return float(rho[np.asarray(state.flags) == FLUID].sum())
    return float(rho.sum())


@pytest.mark.slow  # 1000 steps at 130x130 (98x384) in both packages: up to 2 minutes a scene
@pytest.mark.parametrize("name", sorted(NATIVE))
def test_native_1000_step_drift_matches_jax(name):
    """Over 1000 float32 steps at the demo's default resolution, through
    both runners (which prime the ferrofluid scenes into the scalar carry),
    the summed rho (fluid cells; every cell of the periodic shear layer)
    drifts in the port as in the JAX package, within 1e-3; chip_smoke.py
    holds the card to 1.5 times the JAX drift (SCENE_DRIFT)."""
    from lbm_ferrofluid_tpu_torch import models as pmodels

    build, kw, step = NATIVE[name]
    jp, js = build(**kw)
    pp = SimulationParams.from_json(jp.to_json())
    ps = from_numpy(_jax_fields(js), device="cpu")
    j0, p0 = _summed_rho(js), _summed_rho(ps)
    js = jmodels.SimulationRunner(jp, getattr(jmodels, step + "_impl")).run(js, 1000)
    ps = SimulationRunner(pp, getattr(pmodels, step), device="cpu").run(ps, 1000)
    jd, pd = _summed_rho(js) / j0 - 1.0, _summed_rho(ps) / p0 - 1.0
    assert np.isfinite(jd) and np.isfinite(pd)
    assert abs(pd - jd) <= 1e-3, f"port drift {pd:.3e}, JAX drift {jd:.3e}"
