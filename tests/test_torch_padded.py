"""The padded transposed layout (``params.phys_extent``) in the port, against
the JAX package.

``scenes.rosensweig_3d_tpu`` stores the physical Rosensweig pool
(z_p, y_p, x_p) as array (y_p, z_p, x_p), pads the walled axes with
OBSTACLE cells and puts gravity and the field on array z; the ferrofluid
step ties the reference's array-face behaviours to the physical box.  At
the JAX package's own size for these tests (tests/test_phys_extent.py:
physical 18x10x18, array 10x24x128), on the CPU:

* the scene's state equals the JAX scene's field for field, and
  ``phys_view`` slices scalar and vector fields as the JAX one;
* the scalar carry converts only under the ``_mag_boundary_only`` pad
  contract (a FLUID pad cell, or a magnetic obstacle inside the box, stops
  it: JAX ``test_no_convert_outside_box_fluid``); the primed state has a
  5-leaf premac, a 2-channel h, and keeps force, phi and H_ext;
* B1's psi form (plain) against ``solve_psi_scalar(use_pallas=False)`` at
  1e-6: the port's grouped tap weights against the JAX exact-order sweeps
  (ROADMAP C);
* the box helpers against JAX's: ``_h2_box`` and the contact angle on the
  box at 1e-6 (float32), ``_hcz_capillary_box`` at rel 1e-10 (float64);
* B3's box form (plain; ``bounds``, ``emit_rhs=None``, ``emit_force``)
  against the TPU kernel ``lbm_capillogue`` in interpret mode on seeded
  inputs, every output over the whole array at the float32 contract (rel
  5e-5 a field), and the array-face form far from it;
* 3 steps of the padded capillogue route and of the un-carried route
  against 3 JAX ``ferrofluid_step_impl`` steps on the same padded state,
  through ``phys_view``, at rel 5e-5 (tests/test_phys_extent.py's bar for
  its fused path), and against the port's plain layout at 3e-5 (that
  file's bar for its jnp path).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lbm_ferrofluid_tpu.models import ferrofluid as jff  # noqa: E402
from lbm_ferrofluid_tpu.models import scenes as jscenes  # noqa: E402
from lbm_ferrofluid_tpu.ops import magnetic as jmagnetic  # noqa: E402
from lbm_ferrofluid_tpu.ops import stream_bounce_macro, stream_bounce_moments  # noqa: E402
from lbm_ferrofluid_tpu.ops.collide import MU0  # noqa: E402
from lbm_ferrofluid_tpu.ops.pallas.capillogue import lbm_capillogue as jcapillogue  # noqa: E402

from lbm_ferrofluid_tpu_torch.models import (  # noqa: E402
    ferrofluid_step,
    prime_premac,
    rosensweig_3d,
    scenes,
)
from lbm_ferrofluid_tpu_torch.models import ferrofluid as tff  # noqa: E402
from lbm_ferrofluid_tpu_torch.ops import kernels  # noqa: E402
from lbm_ferrofluid_tpu_torch.ops.kernels import capillogue, scalar_poisson  # noqa: E402
from lbm_ferrofluid_tpu_torch.ops.magnetic import solve_psi_scalar  # noqa: E402
from lbm_ferrofluid_tpu_torch.utils.types import CellType  # noqa: E402

RES = (18, 10, 18)  # physical (z_p, y_p, x_p), tests/test_phys_extent.py's
STEPS = 3
FIELDS = (("density", False), ("pressure", False), ("rho", False), ("vel", True),
          ("f", False), ("g", False), ("h", False))
STATE_FIELDS = ("f", "g", "h", "rho", "vel", "density", "pressure", "force", "phi", "flags",
                "magnetic_flags", "H_ext")


def rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def T(x, dtype=None):
    t = torch.from_numpy(np.array(x))
    return t if dtype is None or t.dtype == torch.uint8 else t.to(dtype)


def port_scene():
    return scenes.rosensweig_3d_tpu(RES, device="cpu")


@pytest.fixture(scope="module", autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_run():
    """The JAX padded scene primed (on the CPU: the scalar carry only) and
    stepped STEPS times by ``ferrofluid_step_impl``."""
    params, state = jscenes.rosensweig_3d_tpu(res=RES)
    state = jff.prime_premac(params, state)
    for _ in range(STEPS):
        state = jff.ferrofluid_step_impl(params, state)
    return params, jax.block_until_ready(state)


@pytest.fixture(scope="module")
def port_runs():
    """The port's padded scene primed, then STEPS steps of the capillogue
    route (5-leaf premac) and of the un-carried route (premac None)."""
    params, state = port_scene()
    primed = prime_premac(params, state, device="cpu")
    runs = {"capillogue": primed, "uncarried": primed.replace(premac=None)}
    for name in runs:
        for _ in range(STEPS):
            runs[name] = ferrofluid_step(params, runs[name], device="cpu")
    return params, runs


def test_scene_state_equals_jax():
    jp, js = jscenes.rosensweig_3d_tpu(res=RES)
    tp, ts = port_scene()
    assert tp.phys_extent == jp.phys_extent == (10, 18, 18)
    assert (tp.gravity_axis, tp.h_ext_axis) == (jp.gravity_axis, jp.h_ext_axis) == (2, 2)
    assert tp.to_json() == jp.to_json()
    assert ts.rho.shape[2:] == (10, 24, 128)
    for name in STATE_FIELDS:
        a, b = getattr(ts, name).numpy(), np.asarray(getattr(js, name))
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    for a, b in zip(ts.H_ext_mac, js.H_ext_mac):
        assert np.array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("field,vector", [("density", False), ("vel", True)])
def test_phys_view_matches_jax(field, vector):
    """phys_view of a seeded field as the JAX one; the physical view of the
    initial density is the plain scene's (tests/test_phys_extent.py)."""
    jp, _ = jscenes.rosensweig_3d_tpu(res=RES)
    tp, ts = port_scene()
    x = np.random.default_rng(3).standard_normal(getattr(ts, field).shape).astype(np.float32)
    got = scenes.phys_view(tp, T(x), vector=vector)
    assert got.shape == ((1, 3) if vector else (1, 1)) + RES
    assert np.array_equal(got.numpy(), np.asarray(jscenes.phys_view(jp, x, vector=vector)))
    pp, plain = rosensweig_3d(RES, device="cpu")
    assert torch.equal(scenes.phys_view(tp, ts.density), plain.density)
    assert scenes.phys_view(pp, plain.density) is plain.density


@pytest.mark.parametrize("where", ["fluid pad cell", "obstacle inside the box"])
def test_scalar_carry_needs_the_pad_contract(where):
    """A FLUID cell in the pad, or a magnetic obstacle inside the box, keeps
    the channel h in both packages; the scene's own flags convert."""
    tp, ts = port_scene()
    jp, js = jscenes.rosensweig_3d_tpu(res=RES)
    assert tff._scalar_convert(tp, ts)[0].shape[1] == 2
    assert jff._scalar_convert(jp, js) is not None
    bad = ts.magnetic_flags.clone()
    bad[..., 5, 20, 60] = int(CellType.FLUID)  # pad: rows past 18, columns past 18
    if where == "obstacle inside the box":
        bad = ts.magnetic_flags.clone()
        bad[..., 5, 9, 9] = int(CellType.OBSTACLE)
    h, cmask = tff._scalar_convert(tp, ts.replace(magnetic_flags=bad))
    assert h is ts.h and h.shape[1] == 19 and cmask is None
    assert jff._scalar_convert(jp, dataclasses.replace(
        js, magnetic_flags=jnp.asarray(bad.numpy()))) is None


def test_primed_structure():
    """prime_premac on the padded layout: 5 macros (the box form emits no
    source), the scalar carry as the JAX priming converts it, and force,
    phi and H_ext kept (JAX :1064-1077); the macros as JAX's jnp stream at
    rel 1e-5 (the moments sum the 19 channels in another order)."""
    tp, ts = port_scene()
    jp, js = jscenes.rosensweig_3d_tpu(res=RES)
    primed = prime_premac(tp, ts, device="cpu")
    jprimed = jff.prime_premac(jp, js)
    assert len(primed.premac) == 5
    assert primed.h.shape == (1, 2, 10, 24, 128) and primed.h.dtype == torch.float32
    assert primed.force is not None and primed.phi is not None and primed.H_ext is not None
    assert np.array_equal(primed.h.numpy(), np.asarray(jprimed.h))
    assert np.array_equal(primed.cmask.numpy(), np.asarray(jprimed.cmask))
    lat = jp.lattice
    gas = dict(rho_gas=jp.rho_gas, rho_fluid=jp.rho_fluid, density_gas=jp.density_gas,
               density_fluid=jp.density_fluid)
    _, rho, vel, den = stream_bounce_macro(lat, js.f, js.flags, js.rho, js.vel, c=1.0,
                                           use_pallas=False, **gas)
    _, m0g, m1g = stream_bounce_moments(lat, js.g, js.flags, False)
    for name, a, b in zip(("rho", "vel", "density", "m0g", "m1g"), primed.premac,
                          (rho, vel, den, m0g, m1g)):
        assert rel(a.numpy(), b) <= 1e-5, name


def seeded_psi_inputs(seed=5):
    tp, ts = port_scene()
    primed = prime_premac(tp, ts, device="cpu")
    rng = np.random.default_rng(seed)
    s2 = primed.h.numpy() + rng.standard_normal(primed.h.shape).astype(np.float32)
    s2 *= (primed.cmask.numpy() >= 0)
    rhs = 1e-3 * rng.standard_normal(ts.rho.shape).astype(np.float32)
    rhs *= (ts.magnetic_flags.numpy() == int(CellType.FLUID))
    return tp, primed, s2, rhs


def test_psi_form_matches_solve_psi_scalar():
    """B1's psi form and ``solve_psi_scalar`` (plain, 30 sweeps on the
    padded arrays) against the JAX ``solve_psi_scalar(use_pallas=False)``
    at rel 1e-6 (the grouped tap weights against the exact order); the
    wrapper's psi form on CPU tensors is its plain version."""
    tp, primed, s2, rhs = seeded_psi_inputs()
    jpsi, js2 = jmagnetic.solve_psi_scalar(
        jnp.asarray(s2), jnp.asarray(primed.cmask.numpy()),
        jnp.asarray(primed.magnetic_flags.numpy()), jnp.asarray(rhs), n_iters=30,
        use_pallas=False)
    psi, out = solve_psi_scalar(T(s2), primed.cmask, T(rhs), n_iters=30, plain=True)
    assert rel(psi.numpy(), jpsi) <= 1e-6
    assert rel(out.numpy(), js2) <= 1e-6
    out2, psi2 = kernels.scalar_wavefront(T(s2), primed.cmask, T(rhs), n_iters=30,
                                          emit="psi")
    assert torch.equal(psi2, psi) and torch.equal(out2, out)
    assert scalar_poisson.launches_per_call(30, s2.shape, emit="psi") == 10
    assert scalar_poisson.launches_per_call(30, s2.shape) == 11
    # the psi form moves the same bytes (psi written where H2 was) and
    # does the sweeps' operations only
    args = (T(s2), primed.cmask, T(rhs))
    psi_cost = scalar_poisson.cost(*args, n_iters=30, emit="psi")
    h2_cost = scalar_poisson.cost(*args, n_iters=30)
    assert psi_cost[0] == h2_cost[0]
    assert h2_cost[1] - psi_cost[1] == scalar_poisson.cost_h2(psi, primed.cmask)[1]


def test_h2_box_matches_jax():
    """H2 on the physical box (B1's H2 launch's plain version on the box
    copy) against JAX ``_h2_box`` at rel 1e-6; zero past the box."""
    tp, primed, s2, rhs = seeded_psi_inputs(7)
    psi = np.random.default_rng(8).standard_normal(primed.rho.shape).astype(np.float32)
    jp, _ = jscenes.rosensweig_3d_tpu(res=RES)
    want = jff._h2_box(jp, jnp.asarray(psi), jnp.asarray(primed.magnetic_flags.numpy()),
                       (0.0, 0.0, 100.0), 1.0)
    got = tff._h2_box(tp, T(psi), primed.cmask, plain=False)
    assert rel(got.numpy(), want) <= 1e-6
    assert float(got[..., :, 18:, :].abs().max()) == 0.0
    assert float(got[..., :, :, 18:].abs().max()) == 0.0
    assert torch.equal(got, tff._h2_box(tp, T(psi), primed.cmask, plain=True))


def test_contact_angle_box_matches_jax():
    """B2's plain version on the box in physical orientation against JAX
    ``_contact_angle_box`` at rel 1e-6, at a non-neutral angle; past the
    box rho is kept."""
    tp, ts = port_scene()
    jp, _ = jscenes.rosensweig_3d_tpu(res=RES)
    tp, jp = tp.replace(contact_angle=0.3 * np.pi), dataclasses.replace(
        jp, contact_angle=0.3 * np.pi)
    rho = ts.rho.numpy() * (1 + 0.05 * np.random.default_rng(9).standard_normal(
        ts.rho.shape)).astype(np.float32)
    want = jff._contact_angle_box(jp, jnp.asarray(rho), jnp.asarray(ts.flags.numpy()))
    got = tff._contact_angle(tp, T(rho), ts.flags, plain=False)
    assert rel(got.numpy(), want) <= 1e-6
    assert not np.array_equal(got.numpy(), rho)
    assert np.array_equal(got[..., :, 18:, :].numpy(), rho[..., :, 18:, :])


def test_hcz_capillary_box_matches_jax():
    """The plain capillary stage on the box against JAX ``_hcz_capillary_box``
    in float64 at rel 1e-10: rho (contact angle on the box), vel, density,
    pressure, force, dfai, dprho over the whole array."""
    tp, ts = port_scene()
    jp, _ = jscenes.rosensweig_3d_tpu(res=RES)
    rng = np.random.default_rng(11)
    shape = tuple(ts.rho.shape)
    vshape = tuple(ts.vel.shape)
    # seeded fields spread over the whole density range, as
    # tests/test_torch_kernels_plain.py seeds its float64 capillary inputs
    rho = jp.rho_gas + (jp.rho_fluid - jp.rho_gas) * rng.uniform(0.0, 1.0, shape)
    den = jp.density_gas + (jp.density_fluid - jp.density_gas) * rng.uniform(0.0, 1.0, shape)
    pres, vel = rng.uniform(0.01, 0.03, shape), rng.uniform(-0.02, 0.02, vshape)
    m0g, m1g = rng.uniform(0.01, 0.03, shape), rng.uniform(-1e-3, 1e-3, vshape)
    H2 = 1e4 * rng.uniform(0.9, 1.1, shape)
    phi = -(2.0 * (den - jp.density_gas) / (jp.density_fluid - jp.density_gas) - 1.0)
    want = jff._hcz_capillary_box(jp, jp.lattice, *(jnp.asarray(x) for x in (
        rho, vel, ts.flags.numpy(), den, pres, H2, phi, m0g, m1g)))
    rho_ca = tff._contact_angle(tp, T(rho), ts.flags, plain=True)
    got = (rho_ca,) + tff._hcz_capillary_box(tp, T(rho), rho_ca, T(vel), ts.flags, T(den),
                                              T(pres), T(H2), T(phi), T(m0g), T(m1g))
    names = ("rho", "vel", "density", "pressure", "force", "dfai", "dprho")
    for name, a, b in zip(names, got, want):
        assert a.dtype == torch.float64
        assert rel(a.numpy(), b) <= 1e-10, name


def capillogue_inputs(seed=0):
    """Seeded physical inputs of B3 on the padded scene: f, g perturbed by
    1 %, the streamed macros and moments of f, g (JAX jnp), pressure and
    rho_ca perturbed, H2 about 1e4."""
    jp, js = jscenes.rosensweig_3d_tpu(res=RES)
    lat = jp.lattice
    rng = np.random.default_rng(seed)
    f = np.asarray(js.f) * (1 + 0.01 * rng.standard_normal(js.f.shape)).astype(np.float32)
    g = np.asarray(js.g) * (1 + 0.01 * rng.standard_normal(js.g.shape)).astype(np.float32)
    gas = dict(rho_gas=jp.rho_gas, rho_fluid=jp.rho_fluid, density_gas=jp.density_gas,
               density_fluid=jp.density_fluid)
    _, rho, vel, den = stream_bounce_macro(lat, jnp.asarray(f), js.flags, js.rho, js.vel,
                                           c=1.0, use_pallas=False, **gas)
    _, m0g, m1g = stream_bounce_moments(lat, jnp.asarray(g), js.flags, False)
    rho = np.asarray(rho, np.float32)
    shape = rho.shape
    pres = np.asarray(js.pressure) * (1 + 0.01 * rng.standard_normal(shape)).astype(np.float32)
    rho_ca = rho * (1 + 1e-3 * rng.standard_normal(shape)).astype(np.float32)
    H2 = (1e4 * (1 + 0.1 * rng.standard_normal(shape))).astype(np.float32)
    args = [f, g, np.asarray(js.flags), rho, np.asarray(den, np.float32), pres, rho_ca, H2,
            np.asarray(m0g, np.float32), np.asarray(m1g, np.float32),
            np.asarray(vel, np.float32)]
    kw = dict(kappa=float(jp.kappa), gravity=tuple(float(v) for v in jp.gravity_vec().ravel()),
              tau_f=jp.tau_f, tau_g=jp.tau_g, dx=1.0, dt=1.0,
              **{k: float(v) for k, v in gas.items()})
    return jp, args, kw


def test_capillogue_box_form_matches_jax_kernel():
    """B3's box form (plain, float32) against the TPU kernel with
    ``bounds=phys_extent[1:]``, ``emit_rhs=None``, ``emit_force=True`` in
    interpret mode: f', g', vel, pressure, density, the 5 emitted macros and
    force at rel <= 5e-5 a field over the whole array (the pad cells
    included: the port writes there what the TPU kernel writes).  The
    array-face form misses by more than 1e-3, so the box matters here."""
    jp, args, kw = capillogue_inputs()
    bounds = tuple(jp.phys_extent[1:])
    jf, jg, jvel, jpres, jforce, jden, jmac = jcapillogue(
        *(jnp.asarray(a) for a in args), None, mu0_half=0.5 * MU0, emit_rhs=None,
        emit_force=True, interpret=True, bounds=bounds, **kw)
    want = [jf, jg, jvel, jpres, jden, *jmac, jforce]
    names = ["f", "g", "vel", "pressure", "density", "mac_rho", "mac_vel", "mac_density",
             "mac_m0g", "mac_m1g", "force"]
    targs = [T(a) for a in args]
    out = kernels.lbm_capillogue(*targs, None, emit_rhs=None, emit_force=True, bounds=bounds,
                                 **kw)
    assert len(out) == 7 and len(out[5]) == 5
    got = [*out[:5], *out[5], out[6]]
    for name, a, b in zip(names, got, want, strict=True):
        assert a.dtype == torch.float32
        assert rel(a.numpy(), b) <= 5e-5, name
    wrong = capillogue.lbm_capillogue_plain(*targs, None, emit_rhs=None, emit_force=True,
                                            bounds=None, **kw)
    assert rel(wrong[2].numpy(), jvel) > 1e-3


def test_capillogue_box_form_at_array_bounds_is_the_array_form():
    """``bounds`` equal to the array's in-plane size is the array-face form,
    bit for bit, and the box form's outputs add force and drop the
    source; its cost adds the 3 force channels, drops the source and the
    magnetic flags, and its launches drop the source's."""
    jp, args, kw = capillogue_inputs(1)
    targs = [T(a) for a in args]
    mflags = targs[2]
    Y, X = targs[0].shape[-2:]
    full = capillogue.lbm_capillogue_plain(*targs, mflags, emit_rhs=(1, 100.0, 1.0), **kw)
    box = capillogue.lbm_capillogue_plain(*targs, None, emit_rhs=None, emit_force=True,
                                          bounds=(Y, X), **kw)
    assert len(full) == 6 and len(full[5]) == 6 and len(box) == 7 and len(box[5]) == 5
    for a, b in zip([*full[:5], *full[5][:5]], [*box[:5], *box[5]]):
        assert torch.equal(a, b)
    nb, nf = capillogue.cost(*targs, mflags, emit_rhs=None, emit_force=True)
    mb, mf = capillogue.cost(*targs, mflags, emit_rhs=(1, 100.0, 1.0))
    n = targs[2].numel()
    assert nb - mb == n * (3 * 4 - 4 - 1)
    assert mf - nf == 52 * int((mflags == int(CellType.FLUID)).sum())
    assert capillogue.launches_per_call(None) == 3 and capillogue.launches_per_call((1, 1, 1)) == 4


@pytest.mark.parametrize("route", ["capillogue", "uncarried"])
def test_padded_routes_match_jax_step(route, jax_run, port_runs):
    """STEPS steps of the port's padded route against STEPS JAX steps on
    the same padded state, through phys_view, at rel 5e-5 a field (vel
    also at abs 5e-6); h (the scalar carry in both) on the box."""
    jp, js = jax_run
    tp, runs = port_runs
    st = runs[route]
    assert int(st.step) == STEPS
    assert (st.premac is None) == (route == "uncarried")
    for name, vector in FIELDS:
        a = scenes.phys_view(tp, getattr(st, name), vector=vector).double().numpy()
        b = np.asarray(jscenes.phys_view(jp, getattr(js, name), vector=vector), np.float64)
        ok = rel(a, b) <= 5e-5 or (name == "vel" and np.abs(a - b).max() <= 5e-6)
        assert ok, (name, rel(a, b))


@pytest.mark.parametrize("route", ["capillogue", "uncarried"])
def test_padded_matches_plain_layout(route, port_runs):
    """The port's padded layout against the port's plain layout at the same
    physical resolution after STEPS steps (capillogue steady state there),
    through phys_view, at rel 3e-5 (tests/test_phys_extent.py's bar): the
    transposed lattice visits the taps in another order."""
    tp, runs = port_runs
    pp, ps = rosensweig_3d(RES, device="cpu")
    ps = prime_premac(pp, ps, device="cpu")
    for _ in range(STEPS):
        ps = ferrofluid_step(pp, ps, device="cpu")
    for name, vector in FIELDS[:4]:
        a = scenes.phys_view(tp, getattr(runs[route], name), vector=vector)
        assert rel(a.numpy(), getattr(ps, name).numpy()) <= 3e-5, name


def test_padded_channel_form_and_hcz_step_raise():
    """A padded state whose h was never converted needs the channel form,
    which composes its gradient at the array faces: the step raises, as
    the JAX step (:485-493).  The HCZ step has no padded layout."""
    from lbm_ferrofluid_tpu_torch.models import hcz_step

    tp, ts = port_scene()
    with pytest.raises(NotImplementedError, match="scalar Poisson carry"):
        ferrofluid_step(tp, ts, device="cpu")
    with pytest.raises(NotImplementedError, match="phys_extent"):
        hcz_step(tp, ts, device="cpu")


def test_padded_routes_launch_nothing_on_the_cpu(port_runs):
    tp, runs = port_runs
    kernels.reset_launch_counts()
    ferrofluid_step(tp, runs["capillogue"], device="cpu")
    ferrofluid_step(tp, runs["uncarried"], device="cpu")
    for path in ("ferrofluid_padded", "ferrofluid_padded_uncarried"):
        assert set(kernels.launch_counts(kernels.PATHS[path]).values()) == {0}
    assert set(kernels.launch_counts(form=True).values()) == {0}
