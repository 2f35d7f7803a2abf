"""The slab forms of B10b, B6 and B5 (``ghosts=``: a z-slab of a domain
decomposed along z over ranks) in the port, on the CPU: the kernels of the
meshed epilogue routes (the 5-leaf epilogue steady state, the out-of-plane
field and the un-carried step).

* Each slab form's plain version against the TPU kernel's ghost mode,
  called directly in interpret mode on one device with the ghost planes
  and clamps given as arrays (no mesh): B10b with ``ghost_lo``/``ghost_hi``
  (the TPU caller zeroes the true edges' planes after its kernel; the
  port's clamp does it in the kernel, so the TPU's output is masked
  likewise), on density(rho_ca) and on rho_ca with ``density_of``, B6 with ``ghosts`` and ``clamp`` at an edge and an interior
  slab, with and without H2, and B5 with ``ghosts`` without and with
  ``emit_mac`` (its macros on the planes [1, Zl-2] where the TPU kernel
  writes them: its wrapper rebuilds the two others, the port's emission,
  B4's slab form on the neighbours' collided planes, writes every plane).
  At the port's float32 contract: rel <= 5e-5 a field, velocities also
  abs <= 5e-6.
* Split and reassemble: a domain cut into 2 and 4 slabs, each slab form's
  plain version fed the neighbours' planes, put back together, equals the
  single-device plain version bit for bit (every cell's arithmetic is the
  same): B10b on density(rho_ca) and on rho_ca with its density map (the
  route's form); B6 with the slabs' Laplacian against the single-device
  stage, which builds the Laplacian itself; B5 with its emission's ghosts
  from the neighbours' collided planes.
* The wrappers' argument checks.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lbm_ferrofluid_tpu.ops.collide import MU0  # noqa: E402
from lbm_ferrofluid_tpu.ops.pallas.capmac import (  # noqa: E402
    hcz_capillary_gradmac as jcapmac,
)
from lbm_ferrofluid_tpu.ops.pallas.fused_step import lbm_epilogue as jepilogue  # noqa: E402
from lbm_ferrofluid_tpu.ops.pallas.stencil3d import laplacian_field as jlaplacian  # noqa: E402
from test_torch_slab_kernels import (  # noqa: E402,F401  (scene and _threads are fixtures)
    RES,
    J,
    _threads,
    close,
    cut,
    fg_ghosts,
    scene,
)

from lbm_ferrofluid_tpu_torch.ops.kernels import capmac, fused_step, stencil3d  # noqa: E402
from lbm_ferrofluid_tpu_torch.ops.moments import phi_from_density, rho_to_density  # noqa: E402

MAC_NAMES = ("rho", "vel", "density", "m0g", "m1g")


def clamp_of(nz, i, Zl):
    return (1 if i == 0 else -1, Zl - 2 if i == nz - 1 else Zl)


def planes(x, nz, i):
    """The plane below slab i and the plane above it (periodic)."""
    return cut(x, nz, i, 1)[:, :, :1], cut(x, nz, i, 0, 1)[:, :, -1:]


@pytest.fixture(scope="module")
def stage(scene):
    """The capillary stage's inputs on the whole domain: density(rho_ca)
    and its Laplacian, phi, and B6's and B5's arguments; B6's outputs."""
    gas, cap = scene["gas"], scene["cap"]
    dens = rho_to_density(scene["rho_ca"], **gas)
    mac = scene["mac"]
    b6 = dict(rho_pre=mac[0], density_pre=mac[2], pressure=scene["pres"],
              rho_ca=scene["rho_ca"], H2=scene["H2"],
              phi=phi_from_density(mac[2], gas["density_gas"], gas["density_fluid"]),
              flags=scene["flags"], g_sum=mac[3], g_mom=mac[4], vel_old=mac[1])
    kw6 = dict(kappa=cap["kappa"], gravity=cap["gravity"], dx=1.0, dt=1.0, **gas)
    vel, pres, force, dfai, dprho = capmac.hcz_capillary_gradmac_plain(*b6.values(), **kw6)
    b5 = dict(f=scene["f"], g=scene["g"], flags=scene["flags"], rho=scene["rho_ca"], vel=vel,
              density=dens, pressure=pres, force=force, dfai=dfai, dprho=dprho)
    kw5 = dict(tau_f=cap["tau_f"], tau_g=cap["tau_g"], dx=1.0, dt=1.0)
    return dict(dens=dens, lap=stencil3d.laplacian_field_plain(dens), b6=b6, kw6=kw6,
                b5=b5, kw5=kw5, mac_consts=(1.0, *gas.values()))


def b6_slab_args(stage, nz, i, kelvin=True):
    """B6's slab arguments of slab i: the slab's fields (and its lap), the
    neighbours' bundles, the clamp."""
    b6 = dict(stage["b6"])
    if not kelvin:
        b6["H2"] = b6["phi"] = None
    args = [None if v is None else cut(v, nz, i) for v in b6.values()]
    fields = [stage["lap"], b6["rho_pre"], b6["density_pre"], b6["pressure"], b6["flags"],
              b6["phi"]]
    ghosts = (capmac.slab_bundle(*(None if x is None else cut(x, nz, (i - 1) % nz)
                                   for x in fields), "lo"),
              capmac.slab_bundle(*(None if x is None else cut(x, nz, (i + 1) % nz)
                                   for x in fields), "hi"))
    return args, cut(stage["lap"], nz, i), ghosts, clamp_of(nz, i, RES[0] // nz)


# ---------------------------------------------------------------------------
# against the TPU kernels' ghost modes (interpret mode, one device)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mapped", [False, True], ids=["density", "rho_ca-mapped"])
@pytest.mark.parametrize("i", [0, 1, 3], ids=["bottom", "interior", "top"])
def test_laplacian_slab_matches_jax(scene, stage, i, mapped):
    """B10b's slab form on density(rho_ca), or on rho_ca with
    ``density_of`` (the route's form), against the TPU kernel's ghost mode
    on density(rho_ca)."""
    nz = 4
    Zl = RES[0] // nz
    dens = stage["dens"]
    x, ghosts, clamp = cut(dens, nz, i), planes(dens, nz, i), clamp_of(nz, i, Zl)
    want = np.array(jlaplacian(J(x), *(J(t) for t in ghosts), dx=1.0, interpret=True))
    if clamp[0] > 0:
        want[:, :, 0] = 0.0
    if clamp[1] < Zl:
        want[:, :, -1] = 0.0
    if mapped:
        rho = scene["rho_ca"]
        got = stencil3d.laplacian_field_plain(cut(rho, nz, i), planes(rho, nz, i), clamp,
                                              density_of=tuple(scene["gas"].values()))
    else:
        got = stencil3d.laplacian_field_plain(x, ghosts, clamp)
    close("lap", got, want)


@pytest.mark.parametrize("kelvin", [True, False], ids=["H2", "no-H2"])
@pytest.mark.parametrize("i", [0, 1], ids=["edge", "interior"])
def test_capmac_slab_matches_jax(stage, i, kelvin):
    """B6's slab form against the TPU kernel's, slab i of 4 (4 planes)."""
    nz = 4
    args, lap, ghosts, clamp = b6_slab_args(stage, nz, i, kelvin)
    got = capmac.hcz_capillary_gradmac_plain(*args, lap, ghosts, clamp, **stage["kw6"])
    order = [0, 1, 2, 3] + ([5] if kelvin else []) + [4]  # JAX: flags last

    def tup(b):
        return tuple(J(b[:, j:j + 1]).astype(jnp.uint8 if j == 4 else jnp.float32)
                     for j in order)

    want = jcapmac(J(lap), *(None if a is None else J(a) for a in args),
                   (tup(ghosts[0]), tup(ghosts[1])), jnp.asarray(clamp, jnp.int32),
                   mu0_half=0.5 * MU0, interpret=True, **stage["kw6"])
    for name, a, b in zip(("vel", "pressure", "force", "dfai", "dprho"), got, want,
                          strict=True):
        close(name, a, b)


@pytest.mark.parametrize("emit_mac", [False, True], ids=["plain", "emit_mac"])
def test_epilogue_slab_matches_jax(scene, stage, emit_mac):
    """B5's slab form against the TPU kernel's, slab 1 of 4 (4 planes); with
    ``emit_mac`` the emission's ghosts are the neighbours' collided planes
    of the whole domain's f'/g'."""
    nz, i = 4, 1
    Zl = RES[0] // nz
    b5 = stage["b5"]
    args = [cut(v, nz, i) for v in b5.values()]
    kw = dict(stage["kw5"], emit_mac=emit_mac,
              mac_consts=stage["mac_consts"] if emit_mac else None)
    emit = None
    if emit_mac:
        whole = fused_step.lbm_epilogue_plain(*b5.values(), **kw)

        def emit(fn, gn):
            return fg_ghosts(whole[0], whole[1], nz, i)

    got = fused_step.lbm_epilogue_plain(*args, fg_ghosts(b5["f"], b5["g"], nz, i), emit, **kw)
    full19 = tuple(J(t) for x in (b5["f"], b5["g"]) for t in planes(x, nz, i))
    want = jepilogue(*(J(a) for a in args), full19, interpret=True, **kw)
    close("f", got[0], want[0])
    close("g", got[1], want[1])
    if emit_mac:
        for name, a, b in zip(MAC_NAMES, got[2], want[2], strict=True):
            close(f"mac {name}", a[:, :, 1:Zl - 1], np.asarray(b)[:, :, 1:Zl - 1])


# ---------------------------------------------------------------------------
# split and reassemble, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mapped", [False, True], ids=["density", "rho_ca-mapped"])
@pytest.mark.parametrize("nz", [2, 4])
def test_laplacian_split_reassembles(scene, stage, nz, mapped):
    """Each slab's B10b on density(rho_ca), or on rho_ca with its density
    map, put back together: the single-device Laplacian of density(rho_ca)
    bit for bit."""
    x = scene["rho_ca"] if mapped else stage["dens"]
    kw = dict(density_of=tuple(scene["gas"].values())) if mapped else {}
    Zl = RES[0] // nz
    parts = [stencil3d.laplacian_field_plain(cut(x, nz, i), planes(x, nz, i),
                                             clamp_of(nz, i, Zl), **kw) for i in range(nz)]
    assert torch.equal(torch.cat(parts, dim=2), stage["lap"])
    assert torch.equal(stencil3d.laplacian_field_plain(x, **kw), stage["lap"])


@pytest.mark.parametrize("nz", [2, 4])
def test_capmac_split_reassembles(stage, nz):
    """Each slab's B6 with its slab of the Laplacian, against the
    single-device stage (which takes the Laplacian itself), bit for bit."""
    whole = capmac.hcz_capillary_gradmac_plain(*stage["b6"].values(), **stage["kw6"])
    parts = [capmac.hcz_capillary_gradmac_plain(*args, lap, ghosts, clamp, **stage["kw6"])
             for args, lap, ghosts, clamp in (b6_slab_args(stage, nz, i) for i in range(nz))]
    for j, w in enumerate(whole):
        assert torch.equal(torch.cat([p[j] for p in parts], dim=2), w), j


@pytest.mark.parametrize("nz", [2, 4])
def test_epilogue_split_reassembles(stage, nz):
    """Each slab's B5 with ``emit_mac``, the emission's ghosts from the
    neighbours' collided planes (the whole domain's f'/g'), bit for bit;
    without ``emit_mac`` its f'/g' alike."""
    b5 = stage["b5"]
    kw = dict(stage["kw5"], emit_mac=True, mac_consts=stage["mac_consts"])
    whole = fused_step.lbm_epilogue_plain(*b5.values(), **kw)
    parts = []
    for i in range(nz):
        def emit(fn, gn, i=i):
            return fg_ghosts(whole[0], whole[1], nz, i)

        args = [cut(v, nz, i) for v in b5.values()]
        fg = fg_ghosts(b5["f"], b5["g"], nz, i)
        parts.append(fused_step.lbm_epilogue_plain(*args, fg, emit, **kw))
        bare = fused_step.lbm_epilogue_plain(*args, fg, **stage["kw5"])
        assert torch.equal(bare[0], parts[-1][0]) and torch.equal(bare[1], parts[-1][1])

    def flat(o):
        return list(o[:2]) + list(o[2])

    for j, w in enumerate(flat(whole)):
        assert torch.equal(torch.cat([flat(p)[j] for p in parts], dim=2), w), j


def test_slab_wrappers_refuse_partial_arguments(stage):
    """The slab forms' arguments come together: B10b's ghosts with a clamp,
    B6's lap, ghosts and clamp, B5's emit_mac with emit_ghosts."""
    nz, i = 4, 1
    dens = stage["dens"]
    with pytest.raises(ValueError, match="ghosts and clamp together"):
        stencil3d.laplacian_field(cut(dens, nz, i), planes(dens, nz, i))
    args, lap, ghosts, clamp = b6_slab_args(stage, nz, i)
    with pytest.raises(ValueError, match="lap, ghosts and clamp together"):
        capmac.hcz_capillary_gradmac(*args, lap, ghosts, **stage["kw6"])
    b5 = stage["b5"]
    with pytest.raises(ValueError, match="emit_ghosts"):
        fused_step.lbm_epilogue(*(cut(v, nz, i) for v in b5.values()),
                                fg_ghosts(b5["f"], b5["g"], nz, i), emit_mac=True,
                                mac_consts=stage["mac_consts"], **stage["kw5"])
    assert math.isclose(stencil3d.cost_laplacian_slab(cut(dens, nz, i), clamp=(-1, 4))[0],
                        8 * 4 * 8 * 12 + 8 * 8 * 12)
