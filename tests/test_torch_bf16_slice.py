"""bfloat16 f/g/h storage (turbo mode) through the port's steps, against the
JAX package, on the CPU (plain versions).

* The slice: 3 steps of ``rosensweig_3d(res=(10, 12, 14))`` on each 3D
  route the port steps, and 3 HCZ steps of ``multiphase_3d``, from the same
  JAX state carried across with ``from_numpy`` (bfloat16 leaves as their
  bits), against 3 JAX steps with ``use_pallas=False``:
  - the un-carried route and the channel form (bfloat16 h) against JAX with
    f, g and h in bfloat16;
  - the primed scalar-carry route and the epilogue steady state against
    JAX with f and g in bfloat16 and h in float32 (JAX's own carry is
    float32, and its jnp path cannot carry a scalar);
  - HCZ against JAX with f and g in bfloat16.
  Bar: the port-vs-JAX distance (max |a - b|) on density, rho and vel is at
  most a quarter of JAX's own bfloat16-vs-float32 distance on the same
  run.  The two measured distances are written beside each route.
* Slow: bfloat16 storage moves the interface and the fluid mass away from
  float32 in the port as in the JAX package (300 steps at 16x66x16).
* bf16 tracks float32 in the port itself: tests/test_bf16_h.py's scene
  (12x10x12, 5 steps) with f, g and h in bfloat16 against float32 on each
  route, at that test's bar (density within 5e-3 of max|density|), and the
  conserved fluid mass at rtol 5e-3.
* The state crosses both ways: a JAX bfloat16 state into the port and back
  through ``from_numpy``/``to_numpy`` keeps every dtype and bit, with or
  without a bfloat16 dtype registered with numpy; priming a state with a
  bfloat16 channel h gives a float32 scalar carry equal to the JAX
  package's conversion (``models/ferrofluid.py:_scalar_convert``).
"""

import dataclasses
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lbm_ferrofluid_tpu import CellType  # noqa: E402
from lbm_ferrofluid_tpu import models as jmodels  # noqa: E402
from lbm_ferrofluid_tpu.models import ferrofluid as jff  # noqa: E402
from lbm_ferrofluid_tpu.models import scenes as jscenes  # noqa: E402

from lbm_ferrofluid_tpu_torch.models import (  # noqa: E402
    SimulationParams,
    ferrofluid_step,
    from_numpy,
    hcz_step,
    init_ferrofluid_state,
    prime_premac,
    to_numpy,
)
from lbm_ferrofluid_tpu_torch.models.state import BF16_BITS  # noqa: E402

RES = (10, 12, 14)
BF = torch.bfloat16
ROOT = pathlib.Path(__file__).resolve().parents[1]


def _jax_fields(state):
    """A JAX state as numpy copies keyed by field name (the JAX step donates
    its input's buffers)."""
    def conv(v):
        if v is None:
            return None
        if isinstance(v, tuple):
            return tuple(conv(x) for x in v)
        return np.array(v)
    return {f.name: conv(getattr(state, f.name)) for f in dataclasses.fields(state)}


def _storage(jp, js, fg, h):
    """The JAX params and state with f/g stored in ``fg`` and h in ``h``, as
    the JAX init casts them."""
    jp = jp.replace(fg_dtype=fg, h_dtype=h)
    kw = dict(f=js.f.astype(jnp.dtype(fg)), g=js.g.astype(jnp.dtype(fg)))
    if hasattr(js, "h"):
        kw["h"] = js.h.astype(jnp.dtype(h))
    return jp, dataclasses.replace(js, **kw)


def _jax_steps(jp, js, n):
    step = jmodels.ferrofluid_step if hasattr(js, "h") else jmodels.hcz_step
    jpp = jp.replace(use_pallas=False)
    for _ in range(n):
        js = step(jpp, js)
    return js


def _five_leaf(params, state):
    primed = prime_premac(params, state, device="cpu")
    return state.replace(h=primed.h, cmask=primed.cmask, premac=primed.premac[:5])


#: route -> (JAX scene builder, f/g dtype, h dtype, params change, port
#: preparation).  The distances measured on this run, port vs JAX against
#: JAX bf16 vs f32 (max |a - b|), are written beside each route.  On the
#: routes with bfloat16 h the port applies the channel weights of the
#: Poisson source in float32, as the TPU kernel does, where the JAX jnp
#: body takes them in h's dtype (bfloat16); with bfloat16 weights the
#: port's density distance there falls to 7.5e-9.
ROUTES = {
    # density 7.6e-6 vs 5.9e-4, rho 7.6e-6 vs 5.9e-4, vel 4.6e-5 vs 1.2e-3
    "uncarried": (jscenes.rosensweig_3d, "bfloat16", "bfloat16", {}, None),
    # the same as un-carried
    "channel": (jscenes.rosensweig_3d, "bfloat16", "bfloat16", dict(scalar_carry=False),
                prime_premac),
    # density 7.5e-9 vs 5.9e-4, rho 7.5e-9 vs 5.9e-4, vel 3.7e-9 vs 1.2e-3
    "scalar_carry": (jscenes.rosensweig_3d, "bfloat16", "float32", {}, prime_premac),
    # the same as the scalar carry
    "epilogue": (jscenes.rosensweig_3d, "bfloat16", "float32", {}, _five_leaf),
    # density 4.5e-8 vs 6.6e-4, rho 4.5e-8 vs 6.6e-4, vel 3.7e-9 vs 6.4e-4
    "hcz": (jscenes.multiphase_3d, "bfloat16", None, {}, None),
}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_three_bf16_steps_track_jax(route):
    build, fg, h, change, prepare = ROUTES[route]
    jp, js = build(res=RES)
    jp = jp.replace(**change)
    # a second scene: the JAX step donates its input's buffers
    jp16, js16 = _storage(jp, build(res=RES)[1], fg, h or "float32")
    pp = SimulationParams.from_json(jp16.to_json())
    ps = from_numpy(_jax_fields(js16), device="cpu")
    ref = _jax_steps(jp, js, 3)
    assert ps.f.dtype == ps.g.dtype == BF
    if h is not None:
        assert ps.h.dtype == getattr(torch, h)
        ps = prepare(pp, ps, device="cpu") if prepare is prime_premac else (
            prepare(pp, ps) if prepare else ps)
    step = ferrofluid_step if h is not None else hcz_step
    for _ in range(3):
        ps = step(pp, ps, device="cpu")
    js16 = _jax_steps(jp16, js16, 3)
    assert ps.step == int(js16.step) == 3
    assert ps.f.dtype == ps.g.dtype == BF and js16.f.dtype == jnp.bfloat16
    if route == "channel":
        assert ps.h.shape[1] == 19 and ps.h.dtype == BF
    if route in ("scalar_carry", "epilogue"):
        assert ps.h.shape[1] == 2 and ps.h.dtype == torch.float32
    for name in ("density", "rho", "vel"):
        port = np.abs(getattr(ps, name).double().numpy()
                      - np.asarray(getattr(js16, name), np.float64)).max()
        own = np.abs(np.asarray(getattr(js16, name), np.float64)
                     - np.asarray(getattr(ref, name), np.float64)).max()
        assert own > 0, name
        assert port <= 0.25 * own, f"{name}: port vs JAX {port:.3e}, JAX bf16 vs f32 {own:.3e}"


@pytest.mark.slow  # 300 steps in both packages and both storage types (about a minute)
def test_bf16_moves_the_interface_and_the_mass_as_in_jax():
    """bfloat16 storage itself moves the interface and the fluid mass away
    from float32, in both packages alike: 300 steps of ``rosensweig_3d``
    at 16x66x16 (un-carried in JAX, the capillogue steady state in the
    port).  Measured: after 30 steps the JAX package's own bfloat16 run
    lies 5.0e-3 of max|density| from its float32 run, the port's 5.1e-3
    (2.3e-3 each after 3 steps); after 300 the bfloat16 fluid mass is
    5.10e-3 below float32's in JAX and 5.16e-3 in the port.  So no
    bfloat16 run of this scene stays within 5e-3 of float32 pointwise
    after 30 steps, nor in mass after 300: chip_smoke.py holds its
    bfloat16 paths to float32 by the dense phase's level, and its
    2000-step run by mass at 2e-2, with the kernels' own share held
    against the plain path."""
    res, n = (16, 66, 16), 300

    def mass(rho, flags):
        return float((np.asarray(rho, np.float64) * (np.asarray(flags) == 1)).sum())

    def jax_run(fg):
        jp, js = _storage(*jscenes.rosensweig_3d(res=res), fg, fg)
        jpp = jp.replace(use_pallas=False)
        for i in range(n):
            js = jmodels.ferrofluid_step(jpp, js)
            if i == 29:
                den = np.array(js.density, np.float64)
        return den, mass(js.rho, js.flags)

    def port_run(fg):
        params, state = _storage(*jscenes.rosensweig_3d(res=res), fg, fg)
        pp = SimulationParams.from_json(params.to_json())
        ps = prime_premac(pp, from_numpy(_jax_fields(state), device="cpu"), device="cpu")
        for i in range(n):
            ps = ferrofluid_step(pp, ps, device="cpu")
            if i == 29:
                den = ps.density.double().numpy()
        return den, mass(ps.rho.numpy(), ps.flags.numpy())

    def apart(run):
        (d32, m32), (d16, m16) = run("float32"), run("bfloat16")
        return np.abs(d16 - d32).max() / np.abs(d32).max(), m16 / m32 - 1.0

    (jax_den, jax_mass), (port_den, port_mass) = apart(jax_run), apart(port_run)
    assert jax_den > 5e-3 and abs(jax_mass) > 5e-3
    assert 0.8 <= port_den / jax_den <= 1.25, (port_den, jax_den)
    assert 0.8 <= port_mass / jax_mass <= 1.25, (port_mass, jax_mass)


# ------------------------------------------------------- bf16 tracks float32
def _scene(dtype, change):
    """tests/test_bf16_h.py's scene with f, g and h stored in ``dtype``."""
    res = (12, 10, 12)
    params = SimulationParams(
        dim=3, density_gas=0.02381, density_fluid=0.2508, rho_gas=0.02381, rho_fluid=0.2508,
        kappa=0.01, tau_f=0.68, tau_g=0.68, gravity=1e-4, mag_strength=85.0,
        poisson_iters=10, fg_dtype=dtype, h_dtype=dtype,
    ).replace(**change)
    flags = np.full((1, 1, *res), int(CellType.OBSTACLE), np.uint8)
    flags[..., 1:-1, 1:-1, 1:-1] = int(CellType.FLUID)
    mflags = np.full((1, 1, *res), int(CellType.OBSTACLE), np.uint8)
    mflags[..., 1:-1, :, 1:-1] = int(CellType.FLUID)
    rho = np.full((1, 1, *res), params.rho_gas, np.float32)
    den = np.full((1, 1, *res), params.density_gas, np.float32)
    rho[..., :5, :] = params.rho_fluid
    den[..., :5, :] = params.density_fluid
    return params, init_ferrofluid_state(params, rho, den, np.zeros((1, 3, *res), np.float32),
                                         flags, mflags, device="cpu")


def _mass(state):
    return float(state.rho.double()[state.flags == int(CellType.FLUID)].sum())


@pytest.mark.parametrize("route", ["uncarried", "scalar_carry", "channel"])
def test_bf16_tracks_float32_in_the_port(route):
    """Measured at 5 steps: max |density difference| 3.0e-3 of
    max|density| on each route; fluid mass 1.3e-3 apart (most of it the
    initial rounding of f to bfloat16)."""
    change = dict(scalar_carry=False) if route == "channel" else {}
    runs = []
    for dtype in ("float32", "bfloat16"):
        params, state = _scene(dtype, change)
        assert state.f.dtype == state.h.dtype == getattr(torch, dtype)
        if route != "uncarried":
            state = prime_premac(params, state, device="cpu")
        for _ in range(5):
            state = ferrofluid_step(params, state, device="cpu")
        assert all(bool(torch.isfinite(getattr(state, n).float()).all())
                   for n in ("f", "g", "h", "rho", "vel", "density", "pressure"))
        runs.append(state)
    s32, s16 = runs
    assert s16.f.dtype == BF and s16.h.dtype == (torch.float32 if route == "scalar_carry"
                                                 else BF)
    d32, d16 = s32.density.double(), s16.density.double()
    assert float((d16 - d32).abs().max()) < 5e-3 * float(d32.abs().max())
    assert _mass(s16) == pytest.approx(_mass(s32), rel=5e-3)


# ------------------------------------------------------- state and priming
def test_jax_bf16_state_round_trips_through_the_port():
    jp, js = _storage(*jscenes.rosensweig_3d(res=RES), "bfloat16", "bfloat16")
    js = _jax_steps(jp, js, 1)
    fields = _jax_fields(js)
    ps = from_numpy(fields, device="cpu")
    back = to_numpy(ps)
    for name in ("f", "g", "h"):
        t = getattr(ps, name)
        assert t.dtype == BF
        np.testing.assert_array_equal(t.view(torch.int16).numpy(), fields[name].view(np.int16))
        # JAX registered numpy's bfloat16 in this process: the arrays go back as it
        assert back[name].dtype == fields[name].dtype
        np.testing.assert_array_equal(back[name].view(np.int16), fields[name].view(np.int16))
    for name in ("rho", "vel", "density", "pressure"):
        assert back[name].dtype == np.float32
        np.testing.assert_array_equal(back[name], fields[name])
    # the port's arrays are the JAX package's own again
    js2 = dataclasses.replace(js, f=jnp.asarray(back["f"]), g=jnp.asarray(back["g"]),
                              h=jnp.asarray(back["h"]))
    assert js2.f.dtype == jnp.bfloat16
    for name in ("f", "g", "h"):
        assert bool((getattr(js2, name) == getattr(js, name)).all())


def test_bf16_state_round_trips_without_a_numpy_bfloat16():
    """Where no module registered a bfloat16 dtype with numpy (the card's
    machine has no ``ml_dtypes``), ``to_numpy`` gives the bits as uint16
    marked bfloat16, and ``from_numpy`` takes them back: every dtype and
    bit survives."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['ml_dtypes'] = None\n"
        "import numpy as np, torch\n"
        "from lbm_ferrofluid_tpu_torch.models import (SimulationParams, rosensweig_3d,\n"
        "    init_ferrofluid_state, prime_premac, ferrofluid_step, from_numpy, to_numpy)\n"
        "p, s = rosensweig_3d(res=(6, 8, 10), device='cpu')\n"
        "p = p.replace(fg_dtype='bfloat16', h_dtype='bfloat16', scalar_carry=False)\n"
        "s = init_ferrofluid_state(p, s.rho, s.density, s.vel, s.flags, s.magnetic_flags,\n"
        "                          device='cpu')\n"
        "s = ferrofluid_step(p, prime_premac(p, s, device='cpu'), device='cpu')\n"
        "a = to_numpy(s)\n"
        "assert a['f'].dtype == np.uint16 and a['f'].dtype.metadata == {'bfloat16': True}\n"
        "b = from_numpy(a, device='cpu')\n"
        "for n in ('f', 'g', 'h', 'rho', 'vel', 'density', 'pressure'):\n"
        "    x, y = getattr(s, n), getattr(b, n)\n"
        "    assert x.dtype == y.dtype, n\n"
        "    assert torch.equal(x.view(torch.int16) if x.dtype == torch.bfloat16 else x,\n"
        "                       y.view(torch.int16) if y.dtype == torch.bfloat16 else y), n\n"
        "assert all(torch.equal(x, y) for x, y in zip(s.premac, b.premac))\n"
        "assert 'ml_dtypes' not in {k for k, v in sys.modules.items() if v is not None}\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
    assert BF16_BITS.metadata == {"bfloat16": True}


def test_priming_a_bf16_h_gives_the_jax_float32_carry():
    """A channel h stored in bfloat16 (after 2 un-carried steps, so it is
    not zero), primed: the carry is float32 and equals the JAX package's
    ``_scalar_convert`` of the same h (rel <= 1e-6: the same float32 sums,
    taken in another order), with the same cmask."""
    jp, js = _storage(*jscenes.rosensweig_3d(res=RES), "bfloat16", "bfloat16")
    js = _jax_steps(jp, js, 2)
    assert js.h.dtype == jnp.bfloat16 and js.h.shape[1] == 19
    jh, jcmask = jff._scalar_convert(jp, js)
    assert jh.dtype == jnp.float32
    pp = SimulationParams.from_json(jp.to_json())
    ps = prime_premac(pp, from_numpy(_jax_fields(js), device="cpu"), device="cpu")
    assert ps.h.dtype == torch.float32 and ps.h.shape[1] == 2
    want = np.asarray(jh, np.float64)
    assert np.abs(ps.h.double().numpy() - want).max() <= 1e-6 * np.abs(want).max()
    assert float(np.abs(want).max()) > 0
    np.testing.assert_array_equal(ps.cmask.numpy(), np.asarray(jcmask))
