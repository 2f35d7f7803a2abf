"""The slab forms of B4, B1, B2 and B3 (``ghosts=``: a z-slab of a domain
decomposed along z over ranks) in the port, on the CPU.

* Each slab form's plain version against the TPU kernel's ghost mode,
  called directly in interpret mode on one device with the ghost planes
  and clamps given as arrays (no mesh): B4 with ``ghosts``; B1 one round
  with ``emit_bands`` and the final ``emit="h2"`` round with the
  ``slab_clamp`` of an interior and of an edge slab; B2 with ``clamp``
  (1, 0), (0, 0) and (0, 1); B3 with ``ghosts``, ``cap_ghosts`` and
  ``clamp`` of an interior and an edge slab, its emitted macros on the
  planes [1, Zl-2] where the TPU kernel writes them (its wrapper rebuilds
  the two others; the port's emission writes every plane).  At the port's
  float32 contract: rel <= 5e-5 a field, velocities also abs <= 5e-6.
* Split and reassemble: a domain cut into 2 and 4 slabs, each slab form's
  plain version fed the neighbours' planes, put back together, equals the
  single-device plain version bit for bit (every cell's arithmetic is the
  same): B4; B1 over 30 sweeps in rounds (10 rounds at 4 slabs), bands
  exchanged between them; B2; B3 with the emission's ghosts from the
  neighbours' collided planes.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lbm_ferrofluid_tpu.ops.collide import MU0  # noqa: E402
from lbm_ferrofluid_tpu.ops.pallas.capillogue import lbm_capillogue as jcapillogue  # noqa: E402
from lbm_ferrofluid_tpu.ops.pallas.contact3d import contact_angle_3d as jcontact  # noqa: E402
from lbm_ferrofluid_tpu.ops.pallas.fused_step import lbm_prologue as jprologue  # noqa: E402
from lbm_ferrofluid_tpu.ops.pallas.scalar_poisson import (  # noqa: E402
    scalar_wavefront as jwavefront,
)

from lbm_ferrofluid_tpu_torch.models import prime_premac, rosensweig_3d  # noqa: E402
from lbm_ferrofluid_tpu_torch.ops.kernels import (  # noqa: E402
    capillogue,
    contact3d,
    fused_step,
    scalar_poisson,
)
from lbm_ferrofluid_tpu_torch.ops.moments import rho_to_density  # noqa: E402
from lbm_ferrofluid_tpu_torch.ops.stencils import isotropic_laplacian  # noqa: E402

RES = (16, 8, 12)
HEXT = (0.0, 85.0, 0.0)
EMIT_RHS = (1, 85.0, 1.0)


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def close(name, got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = float(np.abs(got - want).max())
    assert rel(got, want) <= 5e-5 or ("vel" in name and err <= 5e-6), (name, err)


def J(t):
    return jnp.asarray(t.numpy())


@pytest.fixture(scope="module")
def scene():
    """The port's Rosensweig pool at 16x8x12 (field along y), f and g
    perturbed, with this step's macros, a perturbed pressure and rho_ca,
    an H2 about 1e4, and the scalar carry (random (s, s_prev), the source
    scaled up)."""
    params, st = rosensweig_3d(res=RES, mag_strength=85.0, device="cpu")
    rng = np.random.default_rng(7)

    def pert(x, a):
        return x * (1 + a * torch.from_numpy(rng.standard_normal(x.shape)).to(x.dtype))

    gas = dict(rho_gas=params.rho_gas, rho_fluid=params.rho_fluid,
               density_gas=params.density_gas, density_fluid=params.density_fluid)
    f, g = pert(st.f, 0.01), pert(st.g, 0.01)
    mac = fused_step.lbm_prologue_plain(f, g, st.flags, st.rho, st.vel, c=1.0, **gas)
    primed = prime_premac(params, st, device="cpu")
    s2 = torch.from_numpy(rng.uniform(0.0, 1.0, (1, 2, *RES)).astype(np.float32))
    s2 = s2 * (primed.cmask >= 0)
    return dict(
        params=params, f=f, g=g, flags=st.flags, mflags=st.magnetic_flags, rho=st.rho,
        vel=st.vel, mac=mac, pres=pert(st.pressure, 0.01), rho_ca=pert(mac[0], 1e-3),
        H2=torch.from_numpy((1e4 * (1 + 0.1 * rng.standard_normal((1, 1, *RES)))).astype(
            np.float32)),
        s2=s2, cmask=primed.cmask, rhs=primed.premac[5] * 1e3, gas=gas,
        cap=dict(kappa=float(params.kappa),
                 gravity=tuple(float(v) for v in params.gravity_vec().ravel()),
                 tau_f=params.tau_f, tau_g=params.tau_g, dx=1.0, dt=1.0,
                 **{k: float(v) for k, v in gas.items()}),
    )


def cut(x, nz, i, lo=0, hi=0):
    """Slab i of nz along z, with ``lo`` planes below and ``hi`` above it
    (periodic)."""
    Z = x.shape[2]
    Zl = Z // nz
    idx = torch.arange(i * Zl - lo, (i + 1) * Zl + hi) % Z
    return x[:, :, idx]


def fg_ghosts(f, g, nz, i):
    """B4's and B3's ghosts of slab i: channels 9:14 of the plane below it
    and 14:19 of the plane above it, of f and g."""
    below, above = (i - 1) % nz, (i + 1) % nz
    return (fused_step.ghost_planes(cut(f, nz, below))[0],
            fused_step.ghost_planes(cut(f, nz, above))[1],
            fused_step.ghost_planes(cut(g, nz, below))[0],
            fused_step.ghost_planes(cut(g, nz, above))[1])


# ---------------------------------------------------------------------------
# against the TPU kernels' ghost modes (interpret mode, one device)
# ---------------------------------------------------------------------------

def test_prologue_slab_matches_jax(scene):
    nz, i = 4, 1
    f, g = scene["f"], scene["g"]
    args = [cut(x, nz, i) for x in (f, g, scene["flags"], scene["rho"], scene["vel"])]
    full19 = (cut(f, nz, i, 1)[:, :, :1], cut(f, nz, i, 0, 1)[:, :, -1:],
              cut(g, nz, i, 1)[:, :, :1], cut(g, nz, i, 0, 1)[:, :, -1:])
    want = jprologue(*(J(a) for a in args), tuple(J(t) for t in full19), c=1.0,
                     interpret=True, **scene["gas"])
    got = fused_step.lbm_prologue_plain(*args, fg_ghosts(f, g, nz, i), c=1.0, **scene["gas"])
    for name, a, b in zip(("rho", "vel", "density", "m0g", "m1g"), got, want, strict=True):
        close(name, a, b)


@pytest.mark.parametrize("clamp", [(1, 0), (0, 0), (0, 1)], ids=["bottom", "interior", "top"])
def test_contact_slab_matches_jax(scene, clamp):
    nz = 4
    i = {(1, 0): 0, (0, 0): 1, (0, 1): 3}[clamp]
    rho, flags = scene["rho_ca"], scene["flags"]
    r, fl = cut(rho, nz, i), cut(flags, nz, i)
    ghosts = (cut(rho, nz, i, 1)[:, :, :1], cut(rho, nz, i, 0, 1)[:, :, -1:])
    angle = 0.3 * math.pi
    want = jcontact(J(r), J(fl), angle, ghosts=tuple(J(t) for t in ghosts),
                    clamp=jnp.asarray(clamp, jnp.int32), interpret=True)
    got = contact3d.contact_angle_3d_plain(r, fl, angle, ghosts, clamp)
    close("rho_ca", got, want)
    whole = contact3d.contact_angle_3d_plain(rho, flags, angle)
    assert torch.equal(got, cut(whole, nz, i))


def b1_inputs(scene, nz, i, G):
    s2, cm, rhs = scene["s2"], scene["cmask"], scene["rhs"]
    return (cut(s2, nz, i), cut(cm, nz, i, G, G), cut(rhs, nz, i, G, G),
            (cut(s2, nz, i, G)[:, :, :G], cut(s2, nz, i, 0, G)[:, :, -G:]))


@pytest.mark.parametrize("i", [0, 1], ids=["edge", "interior"])
def test_scalar_slab_rounds_match_jax(scene, i):
    """A round with ``emit_bands`` then the final ``emit="h2"`` round, on a
    slab of 8 planes (2 slabs; k = 2 sweeps a round, G = 3)."""
    nz, k, G = 2, 2, 3
    Zl = RES[0] // nz
    s2, cm, rhs, bands = b1_inputs(scene, nz, i, G)
    s2j, (blo, bhi) = jwavefront(J(s2), J(cm), J(rhs), n_iters=k, emit=None, k=k,
                                 ghosts=tuple(J(b)[0] for b in bands), emit_bands=True,
                                 interpret=True)
    s2p, (plo, phi) = scalar_poisson.scalar_wavefront_plain(
        s2, cm, rhs, n_iters=k, emit=None, ghosts=bands, emit_bands=True)
    close("s2", s2p, s2j)
    close("band_lo", plo[0], blo)
    close("band_hi", phi[0], bhi)
    Ze = Zl + 2 * G
    clamp = (G + 1 if i == 0 else 1, G + Zl - 2 if i == nz - 1 else Ze - 2)
    s2j, h2j = jwavefront(J(s2p), J(cm), J(rhs), n_iters=k, emit="h2", k=k, dx=1.0,
                          h_ext=HEXT, ghosts=tuple(J(b)[0] for b in bands),
                          slab_clamp=jnp.asarray(clamp, jnp.int32), interpret=True)
    s2q, h2q = scalar_poisson.scalar_wavefront_plain(
        s2p, cm, rhs, n_iters=k, h_ext=HEXT, ghosts=bands, slab_clamp=clamp)
    close("s2", s2q, s2j)
    close("H2", h2q, h2j)


def cap_slab_inputs(scene, nz, i, collided=None):
    """B3's inputs of slab i: the slab's fields, f/g ghosts, the two
    capillary bundles, the clamp, and the emission's ghosts from the
    neighbours' planes of ``collided`` (f', g') or, without it, from the
    planes the TPU kernel's caller would exchange."""
    Zl = RES[0] // nz
    names = ("f", "g", "flags", "mac0", "mac2", "pres", "rho_ca", "H2", "mac3", "mac4", "mac1",
             "mflags")
    fields = {**scene, **{f"mac{j}": m for j, m in enumerate(scene["mac"])}}
    args = [cut(fields[n], nz, i) for n in names]
    b, a = (i - 1) % nz, (i + 1) % nz
    bundle = (rho_pre, den_pre, pres, rho_ca, flags) = [
        fields[n] for n in ("mac0", "mac2", "pres", "rho_ca", "flags")]
    cap = (capillogue.cap_bundle(*(cut(x, nz, b) for x in bundle), "lo"),
           capillogue.cap_bundle(*(cut(x, nz, a) for x in bundle), "hi"))
    clamp = (1 if i == 0 else -1, Zl - 2 if i == nz - 1 else Zl)
    fg = fg_ghosts(scene["f"], scene["g"], nz, i)
    emit = None
    if collided is not None:
        def emit(fn, gn):
            return fg_ghosts(*collided, nz, i)
    return args, fg, cap, clamp, emit


@pytest.mark.parametrize("i", [0, 1], ids=["edge", "interior"])
def test_capillogue_slab_matches_jax(scene, i):
    """B3's slab form against the TPU kernel's, slab i of 4 (4 planes)."""
    nz = 4
    Zl = RES[0] // nz
    whole = capillogue.lbm_capillogue_plain(
        *(scene[n] for n in ("f", "g", "flags")), scene["mac"][0], scene["mac"][2],
        scene["pres"], scene["rho_ca"], scene["H2"], scene["mac"][3], scene["mac"][4],
        scene["mac"][1], scene["mflags"], emit_rhs=EMIT_RHS, **scene["cap"])
    args, fg, cap, clamp, emit = cap_slab_inputs(scene, nz, i, whole[:2])
    got = capillogue.lbm_capillogue_plain(*args, fg, cap, clamp, emit, emit_rhs=EMIT_RHS,
                                          **scene["cap"])

    def planes(x, j):  # the [1, 1, 1, Y, X] plane j of a bundle
        return J(x[:, j:j + 1, None])

    dens = rho_to_density(scene["rho_ca"], **scene["gas"])
    lap = isotropic_laplacian(torch.cat([cut(dens, nz, i, 2)[:, :, :3],
                                         cut(dens, nz, i, 0, 2)[:, :, -3:]], dim=2), 1.0)
    lo6 = tuple(planes(cap[0], j) for j in (0, 1, 2, 4, 5)) + (J(lap[:, :, 1:2]),)
    hi6 = tuple(planes(cap[1], j) for j in (0, 1, 2, 3, 5)) + (J(lap[:, :, 4:5]),)
    lo6 = lo6[:4] + (lo6[4].astype(jnp.uint8),) + lo6[5:]
    hi6 = hi6[:4] + (hi6[4].astype(jnp.uint8),) + hi6[5:]
    full19 = tuple(J(t) for t in (cut(scene["f"], nz, i, 1)[:, :, :1],
                                  cut(scene["f"], nz, i, 0, 1)[:, :, -1:],
                                  cut(scene["g"], nz, i, 1)[:, :, :1],
                                  cut(scene["g"], nz, i, 0, 1)[:, :, -1:]))
    jf, jg, jvel, jpres, _force, jden, jmac = jcapillogue(
        *(J(a) for a in args), full19, (lo6, hi6), jnp.asarray(clamp, jnp.int32),
        mu0_half=0.5 * MU0, emit_rhs=EMIT_RHS, emit_force=False, interpret=True,
        **scene["cap"])
    for name, a, b in zip(("f", "g", "vel", "pressure", "density"), got[:5],
                          (jf, jg, jvel, jpres, jden), strict=True):
        close(name, a, b)
    for name, a, b in zip(("rho", "vel", "density", "m0g", "m1g", "rhs"), got[5], jmac,
                          strict=True):
        close(f"mac {name}", a[:, :, 1:Zl - 1], np.asarray(b)[:, :, 1:Zl - 1])


# ---------------------------------------------------------------------------
# split and reassemble, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nz", [2, 4])
def test_prologue_split_reassembles(scene, nz):
    f, g = scene["f"], scene["g"]
    whole = fused_step.lbm_prologue_plain(f, g, scene["flags"], scene["rho"], scene["vel"],
                                          c=1.0, **scene["gas"])
    parts = [fused_step.lbm_prologue_plain(
        *(cut(x, nz, i) for x in (f, g, scene["flags"], scene["rho"], scene["vel"])),
        fg_ghosts(f, g, nz, i), c=1.0, **scene["gas"]) for i in range(nz)]
    for j, w in enumerate(whole):
        assert torch.equal(torch.cat([p[j] for p in parts], dim=2), w)


@pytest.mark.parametrize("nz", [2, 4])
def test_contact_split_reassembles(scene, nz):
    rho, flags, angle = scene["rho_ca"], scene["flags"], 0.3 * math.pi
    whole = contact3d.contact_angle_3d_plain(rho, flags, angle)
    parts = [contact3d.contact_angle_3d_plain(
        cut(rho, nz, i), cut(flags, nz, i), angle,
        (cut(rho, nz, i, 1)[:, :, :1], cut(rho, nz, i, 0, 1)[:, :, -1:]), (i == 0, i == nz - 1))
        for i in range(nz)]
    assert torch.equal(torch.cat(parts, dim=2), whole)


@pytest.mark.parametrize("nz", [2, 4])
def test_scalar_split_reassembles(scene, nz):
    """30 sweeps in rounds of k (G = k + 1 <= Zl: k = 6 at 8 planes, 3 at
    4), the bands of each round's output exchanged before the next."""
    n_iters = 30
    Zl = RES[0] // nz
    k = {8: 6, 4: 3}[Zl]
    G = k + 1
    whole = scalar_poisson.scalar_wavefront_plain(scene["s2"], scene["cmask"], scene["rhs"],
                                                  n_iters=n_iters, h_ext=HEXT)
    s2 = [cut(scene["s2"], nz, i) for i in range(nz)]
    ext = [b1_inputs(scene, nz, i, G)[1:3] for i in range(nz)]
    bands = [b1_inputs(scene, nz, i, G)[3] for i in range(nz)]
    for _ in range(n_iters // k - 1):
        outs = [scalar_poisson.scalar_wavefront_plain(
            s2[i], *ext[i], n_iters=k, emit=None, ghosts=bands[i], emit_bands=True)
            for i in range(nz)]
        s2 = [o[0] for o in outs]
        bands = [(outs[(i - 1) % nz][1][1], outs[(i + 1) % nz][1][0]) for i in range(nz)]
    Ze = Zl + 2 * G
    outs = [scalar_poisson.scalar_wavefront_plain(
        s2[i], *ext[i], n_iters=k, h_ext=HEXT, ghosts=bands[i],
        slab_clamp=(G + 1 if i == 0 else 1, G + Zl - 2 if i == nz - 1 else Ze - 2))
        for i in range(nz)]
    assert torch.equal(torch.cat([o[0] for o in outs], dim=2), whole[0])
    assert torch.equal(torch.cat([o[1] for o in outs], dim=2), whole[1])


@pytest.mark.parametrize("nz", [2, 4])
def test_capillogue_split_reassembles(scene, nz):
    """Each slab's B3 with the emission's ghosts from the neighbours'
    collided planes (the whole domain's f'/g'), bit for bit."""
    whole = capillogue.lbm_capillogue_plain(
        *(scene[n] for n in ("f", "g", "flags")), scene["mac"][0], scene["mac"][2],
        scene["pres"], scene["rho_ca"], scene["H2"], scene["mac"][3], scene["mac"][4],
        scene["mac"][1], scene["mflags"], emit_rhs=EMIT_RHS, **scene["cap"])
    parts = []
    for i in range(nz):
        args, fg, cap, clamp, emit = cap_slab_inputs(scene, nz, i, whole[:2])
        parts.append(capillogue.lbm_capillogue_plain(*args, fg, cap, clamp, emit,
                                                     emit_rhs=EMIT_RHS, **scene["cap"]))

    def flat(o):
        return list(o[:5]) + list(o[5])

    for j, w in enumerate(flat(whole)):
        assert torch.equal(torch.cat([flat(p)[j] for p in parts], dim=2), w), j
