"""bfloat16 f/g/h storage, kernel by kernel: the plain versions of B3, B4,
B5, B8a, B8b, B9 and B11b against the JAX package in its turbo mode.

The same bfloat16 inputs (float32 numpy arrays from a seed, rounded to
bfloat16 by each side: the bits are checked equal) go through the port's
plain version on the CPU and through the JAX function: its plain jnp ops
(``use_pallas=False``), and for B11b its Pallas kernel in interpret mode,
as tests/test_torch_poisson.py runs it.  Bars, each with its reason:

* streamed (permuted, never rounded) bfloat16 values are bit-identical;
* float32 outputs meet the float32 contract of the kernel checks
  (rel <= 5e-5, velocities also at abs <= 5e-6): both sides widen the same
  bfloat16 values exactly and differ only by FMA contraction and sum order.
  An output computed from a bfloat16 intermediate (B3's and B5's emitted
  macros, psi after several sweeps) is held on the same intermediate: the
  port's stage is fed the JAX side's f'/g' (or h), so a one-ulp flip of the
  intermediate is not counted twice;
* bfloat16 outputs are equal or one bfloat16 ulp apart (of the larger
  magnitude): they differ where the float32 values before rounding
  straddle a rounding point, and the share of such elements stays under a
  bound; the share each test measured is written beside its bound.
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
from lbm_ferrofluid_tpu.ops.pallas import poisson as jpoisson  # noqa: E402

from lbm_ferrofluid_tpu_torch.ops import kernels  # noqa: E402
from lbm_ferrofluid_tpu_torch.ops.magnetic import poisson_rhs_scaled  # noqa: E402
from lbm_ferrofluid_tpu_torch.ops.moments import phi_from_density  # noqa: E402

# ops/__init__ re-exports the function ``stream`` over the module's name
jstream = importlib.import_module("lbm_ferrofluid_tpu.ops.stream")

OBS, FLUID = 2, 1
RG, RF = 0.02381, 0.2508
GAS = dict(rho_gas=RG, rho_fluid=RF, density_gas=RG, density_fluid=RF)
BAR_REL, BAR_VEL_ABS = 5e-5, 5e-6
RES = [(6, 8, 10), (10, 12, 14)]
BF = torch.bfloat16


def f64(x):
    """float64 numpy of a torch tensor or a JAX/numpy array (bfloat16 too)."""
    if torch.is_tensor(x):
        return x.double().numpy()
    return np.asarray(x).astype(np.float64)


def bits(x):
    """int16 bits of a bfloat16 torch tensor or JAX array."""
    if torch.is_tensor(x):
        assert x.dtype == BF
        return x.view(torch.int16).numpy()
    assert np.asarray(x).dtype.name == "bfloat16"
    return np.asarray(x).view(np.int16)


def f32_contract(got, want, name, vel=False):
    a, b = f64(got), f64(want)
    err = np.abs(a - b).max()
    r = err / max(np.abs(b).max(), 1e-30)
    assert r <= BAR_REL or (vel and err <= BAR_VEL_ABS), f"{name}: rel {r:.2e} abs {err:.2e}"


def one_ulp(got, want, name, max_share):
    """bfloat16 ``got`` and ``want`` equal or one ulp apart everywhere, in a
    share of the elements under ``max_share``; returns the share."""
    a, b = f64(got), f64(want)
    differ = bits(got) != bits(want)
    big = np.maximum(np.abs(a), np.abs(b))
    ulp = 2.0 ** (np.floor(np.log2(np.where(big > 0, big, 1.0))) - 7)
    assert (np.abs(a - b)[differ] <= ulp[differ]).all(), f"{name}: a difference over one ulp"
    share = float(differ.mean())
    assert share <= max_share, f"{name}: {share:.2e} of the elements differ"
    return share


def _flags(res):
    Z, Y, X = res
    fl = np.full((1, 1, *res), OBS, np.uint8)
    fl[..., 1:-1, 1:-1, 1:-1] = FLUID
    fl[..., Z // 2, Y // 2, 2:4] = OBS
    mf = np.full((1, 1, *res), OBS, np.uint8)
    mf[..., 1:-1, :, 1:-1] = FLUID
    return fl, mf


def _fields(res, seed):
    """float32 inputs; f and g are rounded to bfloat16 by each side."""
    rng = np.random.default_rng(seed)
    fl, mf = _flags(res)
    w = JD3Q19.w_bcast(np.float64)
    rho = RG + (RF - RG) * rng.uniform(0.0, 1.0, (1, 1, *res))
    d = dict(
        rho=rho, den=RG + (RF - RG) * rng.uniform(0.0, 1.0, (1, 1, *res)),
        pres=rng.uniform(0.01, 0.03, (1, 1, *res)),
        vel=rng.uniform(-0.02, 0.02, (1, 3, *res)),
        f=w * rho * (1.0 + 0.1 * rng.standard_normal((1, 19, *res))),
        g=w * 0.02 * (1.0 + 0.1 * rng.standard_normal((1, 19, *res))),
        H2=1e4 * rng.uniform(0.9, 1.1, (1, 1, *res)),
        gsum=rng.uniform(0.01, 0.03, (1, 1, *res)),
        gmom=rng.uniform(-1e-3, 1e-3, (1, 3, *res)),
        force=rng.uniform(-1e-3, 1e-3, (1, 3, *res)),
        dfai=rng.uniform(-1e-3, 1e-3, (1, 3, *res)),
        dprho=rng.uniform(-1e-3, 1e-3, (1, 3, *res)),
    )
    d = {k: v.astype(np.float32) for k, v in d.items()}
    return dict(d, flags=fl, mflags=mf)


def both(d):
    """(port tensors, JAX arrays) of ``d`` with f and g in bfloat16."""
    P = {k: torch.from_numpy(np.array(v)) for k, v in d.items()}
    J = {k: jnp.asarray(v) for k, v in d.items()}
    for k in ("f", "g"):
        P[k], J[k] = P[k].to(BF), J[k].astype(jnp.bfloat16)
        np.testing.assert_array_equal(bits(P[k]), bits(J[k]))
    return P, J


def _jax_macros(f, g, flags, rho_old, vel_old):
    """The JAX prologue's composition: (rho, vel, density, m0g, m1g)."""
    _, rho, vel, den = jstream.stream_bounce_macro(
        JD3Q19, f, flags, rho_old, vel_old, c=1.0, use_pallas=False, **GAS)
    _, m0g, m1g = jstream.stream_bounce_moments(JD3Q19, g, flags, use_pallas=False)
    return rho, vel, den, m0g, m1g


MAC = ("rho", "vel", "density", "m0g", "m1g")


def test_storage_cast_rounds_as_jax():
    """torch's ``.to(bfloat16)`` rounds to nearest even, as JAX's
    ``astype``: the same bits on values at, between and beyond ties."""
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.standard_normal(4096) * 10.0 ** rng.integers(-8, 8, 4096),
                        # exact ties between two bfloat16 values, both parities
                        (np.arange(1, 257, dtype=np.float64) * 2 + 1) * 2.0 ** -9,
                        [0.0, -0.0, 1e-40, 3.4e38]]).astype(np.float32)
    np.testing.assert_array_equal(bits(torch.from_numpy(x).to(BF)),
                                  bits(jnp.asarray(x).astype(jnp.bfloat16)))


# ---------------------------------------------------------------- B8a, B8b
@pytest.mark.parametrize("res", RES)
def test_stream_bounce_macro_bf16(res):
    P, J = both(_fields(res, 1))
    got = kernels.stream_bounce_macro_plain(P["f"], P["flags"], P["rho"], P["vel"], c=1.0,
                                            **GAS)
    want = jstream.stream_bounce_macro(JD3Q19, J["f"], J["flags"], J["rho"], J["vel"], c=1.0,
                                       use_pallas=False, **GAS)
    assert got[0].dtype == BF and all(t.dtype == torch.float32 for t in got[1:])
    np.testing.assert_array_equal(bits(got[0]), bits(want[0]))
    for name, a, b in zip(("rho", "vel", "density"), got[1:], want[1:]):
        f32_contract(a, b, name, vel=name == "vel")


@pytest.mark.parametrize("res", RES)
def test_stream_bounce_moments_bf16(res):
    P, J = both(_fields(res, 2))
    got = kernels.stream_bounce_moments_plain(P["g"], P["flags"])
    want = jstream.stream_bounce_moments(JD3Q19, J["g"], J["flags"], use_pallas=False)
    assert got[0].dtype == BF and got[1].dtype == got[2].dtype == torch.float32
    np.testing.assert_array_equal(bits(got[0]), bits(want[0]))
    f32_contract(got[1], want[1], "m0")
    f32_contract(got[2], want[2], "m1")


# ---------------------------------------------------------------- B4
@pytest.mark.parametrize("res", RES)
def test_prologue_bf16(res):
    P, J = both(_fields(res, 3))
    got = kernels.lbm_prologue_plain(P["f"], P["g"], P["flags"], P["rho"], P["vel"], c=1.0,
                                     **GAS)
    want = _jax_macros(J["f"], J["g"], J["flags"], J["rho"], J["vel"])
    for name, a, b in zip(MAC, got, want):
        assert a.dtype == torch.float32, name
        f32_contract(a, b, name, vel=name == "vel")


# ---------------------------------------------------------------- B9
@pytest.mark.parametrize("res", RES)
def test_hcz_collide_bf16(res):
    """f' and g' one ulp apart in at most 2e-3 of the elements (measured
    here: none; XLA and PyTorch on the CPU round the same float32 values)."""
    P, J = both(_fields(res, 4))
    names = ("rho", "vel", "den", "pres", "flags", "force", "dfai", "dprho")
    got = kernels.hcz_collide_fused_plain(P["f"], P["g"], *(P[n] for n in names), tau_f=0.68,
                                          tau_g=0.7)
    want = jcollide.hcz_collide(JD3Q19, J["f"], J["g"], *(J[n] for n in names), tau_f=0.68,
                                tau_g=0.7, use_pallas=False)
    for name, a, b in zip("fg", got, want):
        one_ulp(a, b, name, 2e-3)


# ---------------------------------------------------------------- B5
@pytest.mark.parametrize("emit_mac", [False, True], ids=["plain", "emit_mac"])
@pytest.mark.parametrize("res", RES)
def test_epilogue_bf16(res, emit_mac):
    """f'/g' one ulp apart in at most 2e-3 of the elements (measured here:
    none); the emitted macros are the prologue's on the port's own f'/g'
    (bit for bit), and that prologue fed the JAX f'/g' meets the float32
    contract against the JAX macros."""
    P, J = both(_fields(res, 5))
    names = ("rho", "vel", "den", "pres", "force", "dfai", "dprho")
    kw = dict(tau_f=0.68, tau_g=0.7)
    out = kernels.lbm_epilogue_plain(P["f"], P["g"], P["flags"], *(P[n] for n in names),
                                     emit_mac=emit_mac, mac_consts=(1.0, RG, RF, RG, RF), **kw)
    jf, jg = (jcollide.hcz_collide(
        JD3Q19, jstream.bounce_back(JD3Q19, jstream.stream(JD3Q19, J["f"]), J["flags"]),
        jstream.bounce_back(JD3Q19, jstream.stream(JD3Q19, J["g"]), J["flags"]),
        J["rho"], J["vel"], J["den"], J["pres"], J["flags"], J["force"], J["dfai"],
        J["dprho"], use_pallas=False, **kw))
    for name, a, b in zip("fg", out[:2], (jf, jg)):
        assert a.dtype == BF
        one_ulp(a, b, name, 2e-3)
    if not emit_mac:
        assert len(out) == 2
        return
    own = kernels.lbm_prologue_plain(out[0], out[1], P["flags"], P["rho"], P["vel"], c=1.0,
                                     **GAS)
    assert all(torch.equal(a, b) for a, b in zip(out[2], own))
    fed = kernels.lbm_prologue_plain(
        torch.from_numpy(np.asarray(jf).view(np.int16).copy()).view(BF),
        torch.from_numpy(np.asarray(jg).view(np.int16).copy()).view(BF),
        P["flags"], P["rho"], P["vel"], c=1.0, **GAS)
    for name, a, b in zip(MAC, fed, _jax_macros(jf, jg, J["flags"], J["rho"], J["vel"])):
        f32_contract(a, b, f"mac {name}", vel=name == "vel")


# ---------------------------------------------------------------- B3
@pytest.mark.parametrize("res", RES)
def test_capillogue_bf16(res):
    """f'/g' one ulp apart in at most 2e-3 of the elements (measured here:
    none); vel, pressure and density at the float32 contract; the next
    step's macros and source from the port's own f'/g' (bit for bit the
    prologue and ``poisson_rhs_scaled`` on them) and, fed the JAX f'/g',
    at the float32 contract against the JAX composition."""
    d = _fields(res, 7)
    P, J = both(d)
    lat = JD3Q19
    kw = dict(kappa=0.01, tau_f=0.68, tau_g=0.68)
    grav = (0.0, float(np.float32(-1e-4)), 0.0)
    angle = 0.4 * math.pi
    rho_ca = jcollide.contact_angle_boundary(J["rho"], J["flags"], angle, 3)

    def phi(den):
        return -(2.0 * (den - RG) / (RF - RG) - 1.0)

    f_post = jstream.bounce_back(lat, jstream.stream(lat, J["f"]), J["flags"])
    g_post = jstream.bounce_back(lat, jstream.stream(lat, J["g"]), J["flags"])
    rho_c, vel, den, pres, force, dfai, dprho = jcollide.hcz_capillary(
        lat, J["rho"], J["vel"], J["flags"], None, J["den"], J["pres"],
        kappa=kw["kappa"], gravity=jnp.asarray(grav, jnp.float32).reshape(1, 3, 1, 1, 1),
        contact_angle=angle, dx=1.0, dt=1.0, H2=J["H2"], phi=phi(J["den"]),
        g_sum=J["gsum"], g_mom=J["gmom"], use_pallas=False, **GAS,
    )
    jf, jg = jcollide.hcz_collide(lat, f_post, g_post, rho_c, vel, den, pres, J["flags"],
                                  force, dfai, dprho, tau_f=kw["tau_f"], tau_g=kw["tau_g"],
                                  use_pallas=False)
    jmac = _jax_macros(jf, jg, J["flags"], rho_c, vel)
    jrhs = jmagnetic.poisson_rhs_scaled(phi(jmac[2]), J["mflags"], None, (0.0, 100.0, 0.0),
                                        tau=1.0, dx=1.0, dt=1.0, dim=3)

    out = kernels.lbm_capillogue_plain(
        P["f"], P["g"], P["flags"], P["rho"], P["den"], P["pres"],
        torch.from_numpy(np.array(rho_ca)), P["H2"], P["gsum"], P["gmom"], P["vel"],
        P["mflags"], gravity=grav, dx=1.0, dt=1.0, emit_rhs=(1, 100.0, 1.0), **kw, **GAS,
    )
    for name, a, b in zip("fg", out[:2], (jf, jg)):
        assert a.dtype == BF
        one_ulp(a, b, name, 2e-3)
    for name, a, b in zip(("vel", "pressure", "density"), out[2:5], (vel, pres, den)):
        assert a.dtype == torch.float32
        f32_contract(a, b, name, vel=name == "vel")

    def stage(f, g):
        mac = kernels.lbm_prologue_plain(f, g, P["flags"], torch.from_numpy(np.array(rho_c)),
                                         out[2], c=1.0, **GAS)
        return mac + (poisson_rhs_scaled(phi_from_density(mac[2], RG, RF), P["mflags"],
                                         (0.0, 100.0, 0.0), tau=1.0, dx=1.0, dt=1.0),)

    assert all(torch.equal(a, b) for a, b in zip(out[5], stage(out[0], out[1])))
    fed = stage(*(torch.from_numpy(np.asarray(x).view(np.int16).copy()).view(BF)
                  for x in (jf, jg)))
    for name, a, b in zip(MAC + ("rhs",), fed, jmac + (jrhs,)):
        f32_contract(a, b, f"mac {name}", vel=name == "vel")


# ---------------------------------------------------------------- B11b
def _poisson_inputs(res, seed):
    rng = np.random.default_rng(seed)
    _, mf = _flags(res)
    Z, Y, X = res
    mf[..., Z // 2 - 1:Z // 2 + 1, Y // 2 - 1:Y // 2 + 1, 5:7] = OBS
    h = rng.uniform(-0.1, 0.1, (1, 19, *res)).astype(np.float32)
    rhs = (rng.uniform(-1e-2, 1e-2, (1, 1, *res)) * (mf == FLUID)).astype(np.float32)
    return h, mf, rhs


@pytest.mark.parametrize("n_iters", [1, 4])
@pytest.mark.parametrize("tau", [1.0, 0.8])
def test_poisson_sweeps_bf16(tau, n_iters):
    """Against the TPU kernel in interpret mode at bfloat16 h: h' one ulp
    apart in at most 1e-3 of the elements (measured here: none), psi
    (float32) at the float32 contract from the same h of the sweep before."""
    h, mf, rhs = _poisson_inputs((6, 8, 16), 11)
    jh0 = jnp.asarray(h).astype(jnp.bfloat16)
    ph0 = torch.from_numpy(h).to(BF)
    np.testing.assert_array_equal(bits(ph0), bits(jh0))
    J = (jnp.asarray(mf), jnp.asarray(rhs))
    P = (torch.from_numpy(mf), torch.from_numpy(rhs))
    jh, jpsi = jpoisson.poisson_sweeps(jh0, *J, tau=tau, n_iters=n_iters, interpret=True)
    ph, ppsi = kernels.poisson_sweeps_plain(ph0, *P, tau=tau, n_iters=n_iters)
    assert ph.dtype == BF and ppsi.dtype == torch.float32
    one_ulp(ph, jh, "h", 1e-3)
    before = jh0
    if n_iters > 1:
        before, _ = jpoisson.poisson_sweeps(jh0, *J, tau=tau, n_iters=n_iters - 1,
                                            interpret=True)
    _, psi_fed = kernels.poisson_sweeps_plain(
        torch.from_numpy(np.asarray(before).view(np.int16).copy()).view(BF), *P, tau=tau,
        n_iters=1)
    f32_contract(psi_fed, jpsi, "psi")


# ---------------------------------------------------------------- bounds
@pytest.mark.parametrize("kid", ["B3", "B4", "B5", "B5 emit_mac", "B8a", "B8b", "B9", "B11b"])
def test_cost_counts_two_bytes_a_stored_element(kid):
    """Each bf16 form's ``cost`` counts 2 bytes for every f/g/h element it
    reads or writes, 4 for float32: the difference is 38 B a cell for each
    distribution moved (B3: f, g read, f', g' written; B5 the same; B4 f,
    g read; B8a/B8b f read, f_post written; B9 as B5; B11b h read, h'
    written), and the operations do not change."""
    res = (6, 8, 10)
    n = math.prod(res)
    d = _fields(res, 9)
    P = {k: torch.from_numpy(np.array(v)) for k, v in d.items()}
    base = kid.split()[0]
    k = kernels.KERNELS[base]
    if base in ("B3", "B4", "B5", "B9"):
        args = {
            "B3": (P["f"], P["g"], P["flags"], P["rho"], P["den"], P["pres"], P["rho"],
                   P["H2"], P["gsum"], P["gmom"], P["vel"], P["mflags"]),
            "B4": (P["f"], P["g"], P["flags"], P["rho"], P["vel"]),
            "B5": (P["f"], P["g"], P["flags"], P["rho"], P["vel"], P["den"], P["pres"],
                   P["force"], P["dfai"], P["dprho"]),
            "B9": (P["f"], P["g"], P["rho"], P["vel"], P["den"], P["pres"], P["flags"],
                   P["force"], P["dfai"], P["dprho"]),
        }[base]
        kw = dict(emit_mac=kid.endswith("emit_mac"), mac_consts=(1.0, RG, RF, RG, RF))
        moved = 2 if base == "B4" else 4

        def bf16(a):
            return tuple(x.to(BF) if i < 2 else x for i, x in enumerate(a))
    else:
        if base == "B11b":
            args, kw = (torch.from_numpy(_poisson_inputs(res, 1)[0]), P["mflags"],
                        P["H2"]), dict(tau=1.0, n_iters=30)
        else:
            args = (P["f"], P["flags"]) + ((P["rho"], P["vel"]) if base == "B8b" else ())
            kw = {}
        moved = 2

        def bf16(a):
            return (a[0].to(BF),) + tuple(a[1:])
    b32, o32 = k.cost(*args, **kw)
    b16, o16 = k.cost(*bf16(args), **kw)
    assert o16 == o32 and b32 - b16 == moved * 38 * n
