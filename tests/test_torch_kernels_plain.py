"""Each kernel's plain PyTorch version against its JAX twin, in float64.

The plain versions are what the CUDA kernels are held against on the card
(``chip_smoke.py``) and what the port runs on the CPU.  Inputs are made from
a numpy seed and given to both sides; JAX runs its plain jnp ops
(``use_pallas=False``) on the CPU with x64 enabled (tests/conftest.py).

Bars, each with its reason:
* B1 sweeps, B2, B4: rel <= 1e-12 — the same taps in the same order, so
  only float64 rounding of identical arithmetic remains.
* B1 H2 composition and B3: rel <= 1e-10 — the same formulas, with sums
  associated differently (jnp reductions, per-channel vs per-tap forms).
* B1 sweeps + H2 against ``solve_H_int_scalar(use_pallas=False)``: that
  function runs the exact per-tap order with weights f32(w_q) * 1.5, while
  the TPU kernel and the port use the grouped taps f32(1.5/18) and
  f32(1.5/36); the two weight sets differ by 2.2e-8 relative, which 30
  sweeps carry to ~2e-7 on these inputs (the reassociation alone is
  ~1e-15), so the bar is 1e-6.
"""

import importlib
import math

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lbm_ferrofluid_tpu.lattice import D3Q19 as JD3Q19  # noqa: E402
from lbm_ferrofluid_tpu.ops import collide as jcollide  # noqa: E402
from lbm_ferrofluid_tpu.ops import magnetic as jmagnetic  # noqa: E402
from lbm_ferrofluid_tpu.ops.pallas.scalar_poisson import scalar_sweeps_cmask  # noqa: E402
from lbm_ferrofluid_tpu.ops.scalar_poisson import make_cmask as jmake_cmask  # noqa: E402
from lbm_ferrofluid_tpu.ops.stencils import isotropic_grad as jgrad  # noqa: E402

from lbm_ferrofluid_tpu_torch.ops import kernels  # noqa: E402

from lbm_ferrofluid_tpu_torch.ops.kernels.scalar_poisson import (  # noqa: E402
    h2_from_psi_plain,
    scalar_sweeps_plain,
)

# ops/__init__ re-exports the function ``stream`` over the module's name
jstream = importlib.import_module("lbm_ferrofluid_tpu.ops.stream")

OBS, FLUID = 2, 1
RG, RF = 0.02381, 0.2508
GAS = dict(rho_gas=RG, rho_fluid=RF, density_gas=RG, density_fluid=RF)


def rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def T(x):
    return torch.from_numpy(np.array(x))


def _flags(res):
    """Hydrodynamic frame plus an interior obstacle block; magnetic shell
    (x-edge columns and z planes), the Rosensweig pattern."""
    Z, Y, X = res
    fl = np.full((1, 1, *res), OBS, np.uint8)
    fl[..., 1:-1, 1:-1, 1:-1] = FLUID
    fl[..., Z // 2, Y // 2, 2:4] = OBS
    mf = np.full((1, 1, *res), OBS, np.uint8)
    mf[..., 1:-1, :, 1:-1] = FLUID
    return fl, mf


def _fields(res, seed):
    rng = np.random.default_rng(seed)
    Z, Y, X = res
    fl, mf = _flags(res)
    rho = RG + (RF - RG) * rng.uniform(0.0, 1.0, (1, 1, *res))
    den = RG + (RF - RG) * rng.uniform(0.0, 1.0, (1, 1, *res))
    w = JD3Q19.w_bcast(np.float64)
    return dict(
        flags=fl, mflags=mf, rho=rho, den=den,
        pres=rng.uniform(0.01, 0.03, (1, 1, *res)),
        vel=rng.uniform(-0.02, 0.02, (1, 3, *res)),
        f=w * rho * (1.0 + 0.1 * rng.standard_normal((1, 19, *res))),
        g=w * 0.02 * (1.0 + 0.1 * rng.standard_normal((1, 19, *res))),
        H2=1e4 * rng.uniform(0.9, 1.1, (1, 1, *res)),
        gsum=rng.uniform(0.01, 0.03, (1, 1, *res)),
        gmom=rng.uniform(-1e-3, 1e-3, (1, 3, *res)),
    )


RES = [(6, 8, 10), (10, 12, 14)]


# ---------------------------------------------------------------- B4
@pytest.mark.parametrize("res", RES)
def test_prologue_plain_matches_jax(res):
    d = _fields(res, 1)
    _, rho, vel, den = jstream.stream_bounce_macro(
        JD3Q19, jnp.asarray(d["f"]), jnp.asarray(d["flags"]), jnp.asarray(d["rho"]),
        jnp.asarray(d["vel"]), c=1.0, use_pallas=False, **GAS,
    )
    _, m0g, m1g = jstream.stream_bounce_moments(
        JD3Q19, jnp.asarray(d["g"]), jnp.asarray(d["flags"]), use_pallas=False
    )
    got = kernels.lbm_prologue_plain(
        T(d["f"]), T(d["g"]), T(d["flags"]), T(d["rho"]), T(d["vel"]), c=1.0, **GAS
    )
    for name, a, b in zip(("rho", "vel", "density", "m0g", "m1g"), got,
                          (rho, vel, den, m0g, m1g)):
        assert rel(a, b) <= 1e-12, name


# ---------------------------------------------------------------- B1
def _scalar_inputs(res, seed):
    rng = np.random.default_rng(seed)
    _, mf = _flags(res)
    cmask = np.asarray(jmake_cmask(jnp.asarray(mf)), np.float32)
    fluid = (mf != OBS).astype(np.float64)
    # float32-representable inputs: the JAX twin casts cmask/rhs to float32
    s2 = np.concatenate([
        rng.standard_normal((1, 1, *res)) * fluid,
        rng.standard_normal((1, 1, *res)) * fluid,
    ], axis=1)
    rhs = rng.standard_normal((1, 1, *res)).astype(np.float32) * fluid
    return mf, cmask.astype(np.float64), s2, rhs


@pytest.mark.parametrize("res", RES)
def test_scalar_sweeps_plain_matches_jax(res):
    mf, cmask, s2, rhs = _scalar_inputs(res, 2)
    js2, jpsi = scalar_sweeps_cmask(jnp.asarray(s2), jnp.asarray(cmask),
                                    jnp.asarray(rhs), 30)
    ps2, ppsi = scalar_sweeps_plain(T(s2), T(cmask), T(rhs), 30)
    assert rel(ps2, js2) <= 1e-12
    assert rel(ppsi, jpsi) <= 1e-12


@pytest.mark.parametrize("res", RES)
def test_h2_composition_matches_jax(res):
    mf, cmask, _, _ = _scalar_inputs(res, 3)
    psi = np.random.default_rng(4).standard_normal((1, 1, *res))
    h_ext = (0.0, 100.0, 0.0)
    want = jmagnetic._maybe_h2(-jgrad(jnp.asarray(psi), 1.0, jnp.asarray(mf), 3), h_ext)
    got = h2_from_psi_plain(T(psi), T(cmask), 1.0, h_ext)
    assert rel(got, want) <= 1e-10


@pytest.mark.parametrize("res", RES)
def test_scalar_wavefront_plain_matches_solve_H_int_scalar(res):
    mf, cmask, s2, rhs = _scalar_inputs(res, 5)
    h_ext = (0.0, 100.0, 0.0)
    H2, js2 = jmagnetic.solve_H_int_scalar(
        jnp.asarray(s2), jnp.asarray(cmask), jnp.asarray(mf), jnp.asarray(rhs),
        n_iters=30, dx=1.0, h2_ext=h_ext, use_pallas=False,
    )
    ps2, pH2 = kernels.scalar_wavefront_plain(
        T(s2), T(cmask), T(rhs), n_iters=30, dx=1.0, h_ext=h_ext
    )
    assert rel(ps2, js2) <= 1e-6
    assert rel(pH2, H2) <= 1e-6


# ---------------------------------------------------------------- B2
@pytest.mark.parametrize("angle", [0.5 * math.pi, 0.35 * math.pi])
@pytest.mark.parametrize("res", RES)
def test_contact_angle_plain_matches_jax(res, angle):
    d = _fields(res, 6)
    # obstacles on every face so each surgery group writes
    want = jcollide.contact_angle_boundary(
        jnp.asarray(d["rho"]), jnp.asarray(d["flags"]), angle, 3
    )
    got = kernels.contact_angle_3d_plain(T(d["rho"]), T(d["flags"]), angle)
    assert rel(got, want) <= 1e-12
    # the wrapper on CPU tensors is the plain version, and rho is untouched
    rho = T(d["rho"]).clone()
    np.testing.assert_array_equal(
        kernels.contact_angle_3d(rho, T(d["flags"]), angle).numpy(), got.numpy()
    )
    np.testing.assert_array_equal(rho.numpy(), d["rho"])


# ---------------------------------------------------------------- B3
@pytest.mark.parametrize("res", RES)
def test_capillogue_plain_matches_jax_composition(res):
    d = _fields(res, 7)
    lat = JD3Q19
    kw = dict(kappa=0.01, tau_f=0.68, tau_g=0.68)
    grav = (0.0, float(np.float32(-1e-4)), 0.0)
    angle = 0.4 * math.pi
    J = {k: jnp.asarray(v) for k, v in d.items()}
    rho_ca = jcollide.contact_angle_boundary(J["rho"], J["flags"], angle, 3)

    def phi(den):
        return -(2.0 * (den - RG) / (RF - RG) - 1.0)

    f_post = jstream.bounce_back(lat, jstream.stream(lat, J["f"]), J["flags"])
    g_post = jstream.bounce_back(lat, jstream.stream(lat, J["g"]), J["flags"])
    rho_c, vel, den, pres, force, dfai, dprho = jcollide.hcz_capillary(
        lat, J["rho"], J["vel"], J["flags"], None, J["den"], J["pres"],
        kappa=kw["kappa"], gravity=jnp.asarray(grav).reshape(1, 3, 1, 1, 1),
        contact_angle=angle, dx=1.0, dt=1.0, H2=J["H2"], phi=phi(J["den"]),
        g_sum=J["gsum"], g_mom=J["gmom"], use_pallas=False, **GAS,
    )
    f_n, g_n = jcollide.hcz_collide(
        lat, f_post, g_post, rho_c, vel, den, pres, J["flags"], force, dfai, dprho,
        tau_f=kw["tau_f"], tau_g=kw["tau_g"], use_pallas=False,
    )
    _, rho_n, vel_n, den_n = jstream.stream_bounce_macro(
        lat, f_n, J["flags"], rho_c, vel, c=1.0, use_pallas=False, **GAS
    )
    _, m0g_n, m1g_n = jstream.stream_bounce_moments(lat, g_n, J["flags"], use_pallas=False)
    rhs_n = jmagnetic.poisson_rhs_scaled(
        phi(den_n), J["mflags"], None, (0.0, 100.0, 0.0), tau=1.0, dx=1.0, dt=1.0, dim=3
    )
    want = (f_n, g_n, vel, pres, den, rho_n, vel_n, den_n, m0g_n, m1g_n, rhs_n)

    out = kernels.lbm_capillogue_plain(
        T(d["f"]), T(d["g"]), T(d["flags"]), T(d["rho"]), T(d["den"]), T(d["pres"]),
        T(np.asarray(rho_ca)), T(d["H2"]), T(d["gsum"]), T(d["gmom"]), T(d["vel"]),
        T(d["mflags"]), gravity=grav, dx=1.0, dt=1.0, emit_rhs=(1, 100.0, 1.0),
        **kw, **GAS,
    )
    got = out[:5] + tuple(out[5])
    names = ("f", "g", "vel", "pressure", "density", "mac rho", "mac vel",
             "mac density", "m0g", "m1g", "rhs")
    assert len(got) == len(want)
    for name, a, b in zip(names, got, want):
        assert rel(a, b) <= 1e-10, f"{name}: {rel(a, b):.2e}"


def test_capillogue_plain_emits_rhs_at_the_magnetic_tau():
    """The emitted Poisson source carries the factor cs2 (0.5 - tau) dt of
    the magnetic tau; tau = 1 would hide a wrong tau."""
    d = _fields(RES[0], 11)
    T_ = {k: T(v) for k, v in d.items()}
    kw = dict(kappa=0.01, gravity=(0.0, -1e-4, 0.0), tau_f=0.68, tau_g=0.68, dx=1.0,
              dt=1.0, **GAS)
    args = (T_["f"], T_["g"], T_["flags"], T_["rho"], T_["den"], T_["pres"], T_["rho"],
            T_["H2"], T_["gsum"], T_["gmom"], T_["vel"], T_["mflags"])
    mac = kernels.lbm_capillogue_plain(*args, emit_rhs=(1, 100.0, 0.8), **kw)[5]
    mac1 = kernels.lbm_capillogue_plain(*args, emit_rhs=(1, 100.0, 1.0), **kw)[5]
    phi = -(2.0 * (mac[2].numpy() - RG) / (RF - RG) - 1.0)
    want = jmagnetic.poisson_rhs_scaled(jnp.asarray(phi), jnp.asarray(d["mflags"]), None,
                                        (0.0, 100.0, 0.0), tau=0.8, dx=1.0, dt=1.0, dim=3)
    assert rel(mac[5], want) <= 1e-12
    # (0.5 - 0.8) / (0.5 - 1.0) of the tau == 1 source
    assert rel(mac[5], 0.6 * mac1[5]) <= 1e-12 and float(mac[5].abs().max()) > 0


# ---------------------------------------------------------------- bounds
def _leaves(out):
    if isinstance(out, (tuple, list)):
        return [t for x in out for t in _leaves(x)]
    return [out]


@pytest.mark.parametrize("kid", ["B1", "B2", "B3", "B4", "B5", "B5 emit_mac", "B6",
                                 "B6 without H2", "B8a", "B8b", "B9", "B10a", "B10b",
                                 "B11b"])
def test_cost_leaves_out_only_unread_inputs(kid):
    """A kernel's bound (``cost``) counts some inputs only at some cells.
    New values at the cells it leaves out must leave every output of the
    plain version exactly as it was, and the count must be the full one
    (each input read and each output written at every cell) less exactly
    those cells.  B8a, B10a and B10b read every input everywhere: nothing is
    left out."""
    res = (6, 8, 10)
    n = int(np.prod(res))
    rng = np.random.default_rng(8)
    d = {k: T(v) for k, v in _fields(res, 9).items()}
    fluid, obs = d["flags"] == FLUID, d["flags"] == OBS

    def new(t, where):
        return torch.where(where, T(rng.uniform(-1.0, 1.0, tuple(t.shape))), t)

    if kid == "B1":
        _, cmask, s2, rhs = (T(v) for v in _scalar_inputs(res, 10))
        args, kw = [s2, cmask, rhs], dict(n_iters=3, dx=1.0, h_ext=(0.0, 100.0, 0.0))
        # s_prev only where c > 0, rhs only at fluid cells
        s2_new = torch.cat([s2[:, :1], new(s2[:, 1:], cmask <= 0)], dim=1)
        changed = [s2_new, cmask, new(rhs, cmask < 0)]
        full, left_out = 28 * n, 4 * int((cmask <= 0).sum() + (cmask < 0).sum())
    elif kid == "B2":
        face = torch.zeros(res, dtype=torch.bool)
        face[1:-1, 1:-1, [0, -1]] = face[1:-1, [0, -1], 1:-1] = face[[0, -1], 1:-1, 1:-1] = True
        args, kw = [d["rho"], d["flags"], 0.4 * math.pi], {}
        other = T(rng.integers(0, 3, (1, 1, *res)).astype(np.uint8))
        changed = [d["rho"], torch.where(face, d["flags"], other), 0.4 * math.pi]
        full, left_out = 9 * n, int((~face).sum())
    elif kid == "B3":
        args = [d["f"], d["g"], d["flags"], d["rho"], d["den"], d["pres"], d["rho"],
                d["H2"], d["gsum"], d["gmom"], d["vel"], d["mflags"]]
        kw = dict(kappa=0.01, gravity=(0.0, -1e-4, 0.0), tau_f=0.68, tau_g=0.68,
                  dx=1.0, dt=1.0, emit_rhs=(1, 100.0, 1.0), **GAS)
        # H2, g_sum, g_mom only at fluid cells, vel_old only at the others
        changed = args[:7] + [new(t, ~fluid) for t in args[7:10]] + [new(args[10], fluid),
                                                                    args[11]]
        n_fluid = int(fluid.sum())
        full, left_out = 414 * n, 20 * (n - n_fluid) + 12 * n_fluid
    elif kid == "B4":
        args, kw = [d["f"], d["g"], d["flags"], d["rho"], d["vel"]], dict(c=1.0, **GAS)
        # rho_old and vel_old only at obstacles
        changed = args[:3] + [new(args[3], ~obs), new(args[4], ~obs)]
        full, left_out = 205 * n, 16 * int((~obs).sum())
    elif kid.startswith("B6"):
        kelvin = kid == "B6"
        flags = d["flags"].clone()
        flags[..., 1:-1, 0, 1:-1] = FLUID  # fluid ring cells: pressure unread there
        fluid = flags == FLUID
        ring = torch.ones_like(fluid)
        ring[..., 1:-1, 1:-1, 1:-1] = False
        corner = torch.zeros_like(fluid)
        corner[..., ::res[0] - 1, ::res[1] - 1, ::res[2] - 1] = True
        phi = T(rng.uniform(-1.2, 1.2, (1, 1, *res)))
        H2, phi = (d["H2"], phi) if kelvin else (None, None)
        args = [d["rho"], d["den"], d["pres"], d["rho"], H2, phi, flags, d["gsum"],
                d["gmom"], d["vel"]]
        kw = dict(kappa=0.01, gravity=(0.0, -1e-4, 0.0), **GAS)
        # rho_pre/density_pre off the ring, pressure at interior and non-fluid
        # ring cells, phi where neither a ring obstacle nor a corner, g_sum and
        # g_mom at fluid cells, vel_old at the others
        ring_obs = ring & ((flags == OBS) | corner)
        changed = [new(d["rho"], ring), new(d["den"], ring), new(d["pres"], ring & fluid),
                   d["rho"], H2, new(phi, ring_obs) if kelvin else None, flags,
                   new(d["gsum"], ~fluid), new(d["gmom"], ~fluid), new(d["vel"], fluid)]
        n_ring, n_fluid = int(ring.sum()), int(fluid.sum())
        full = (105 if kelvin else 97) * n
        left_out = (8 * n_ring + 4 * int((ring & fluid).sum()) + 16 * (n - n_fluid)
                    + 12 * n_fluid + (4 * int(ring_obs.sum()) if kelvin else 0))
    elif kid.startswith("B5"):
        emit = kid == "B5 emit_mac"
        flags = d["flags"].clone()
        flags[..., 2, 3, 4:7] = 4  # EMPTY: neither fluid nor obstacle
        fluid, obs = flags == FLUID, flags == OBS
        macros = [d["rho"], d["vel"], d["den"], d["pres"]] + [
            T(rng.uniform(-1e-3, 1e-3, (1, 3, *res))) for _ in range(3)]
        args = [d["f"], d["g"], flags] + macros
        kw = dict(tau_f=0.7, tau_g=0.7, emit_mac=emit, mac_consts=(1.0, RG, RF, RG, RF))
        # the macro fields only at fluid cells; with emit_mac rho and vel also
        # at obstacles (the emission's frozen values)
        read_rv = (fluid | obs) if emit else fluid
        changed = args[:3] + [new(t, ~read_rv) for t in macros[:2]] + [
            new(t, ~fluid) for t in macros[2:]]
        full = (401 if emit else 365) * n
        left_out = 16 * int((~read_rv).sum()) + 44 * int((~fluid).sum())
    elif kid == "B10b":
        args, kw = [T(rng.standard_normal((1, 1, *res)))], dict(dx=1.0)
        changed, full, left_out = args, 8 * n, 0
    elif kid == "B8a":
        args, kw = [d["f"], d["flags"]], {}
        changed, full, left_out = args, 169 * n, 0
    elif kid == "B10a":
        args, kw = [T(rng.standard_normal((1, 2, *res)))], dict(dx=1.0)
        changed, full, left_out = args, 32 * n, 0
    elif kid == "B11b":
        h = T(rng.uniform(-0.1, 0.1, (1, 19, *res)))
        rhs = T(rng.uniform(-1e-3, 1e-3, (1, 1, *res)))
        mf = d["mflags"].clone()
        mf[..., 2:4, 3:5, 4:6] = OBS
        args, kw = [h, mf, rhs], dict(tau=0.8, n_iters=3)
        # rhs only at non-obstacle cells
        changed = [h, mf, new(rhs, mf == OBS)]
        full, left_out = 161 * n, 4 * int((mf == OBS).sum())
    elif kid == "B8b":
        args, kw = [d["f"], d["flags"], d["rho"], d["vel"]], dict(c=1.0, **GAS)
        # rho_old and vel_old only at obstacles
        changed = args[:2] + [new(args[2], ~obs), new(args[3], ~obs)]
        full, left_out = 189 * n, 16 * int((~obs).sum())
    else:
        extra = {k: T(rng.uniform(-1e-3, 1e-3, (1, 3, *res))) for k in ("force", "dfai",
                                                                     "dprho")}
        args = [d["f"], d["g"], d["rho"], d["vel"], d["den"], d["pres"], d["flags"],
                extra["force"], extra["dfai"], extra["dprho"]]
        kw = dict(tau_f=0.7, tau_g=0.7)
        # the macro fields only at fluid cells (the others keep f and g)
        changed = args[:2] + [new(t, ~fluid) for t in args[2:6]] + [args[6]] + [
            new(t, ~fluid) for t in args[7:]]
        full, left_out = 365 * n, 60 * int((~fluid).sum())
    k = kernels.KERNELS[kid.split()[0]]
    want, got = _leaves(k.plain(*args, **kw)), _leaves(k.plain(*changed, **kw))
    assert (left_out > 0) == (kid not in ("B8a", "B10a", "B10b")) and len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert torch.equal(a, b), f"{kid} output {i} reads a left-out input"
    assert k.cost(*args, **kw)[0] == full - left_out
