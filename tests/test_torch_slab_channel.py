"""The slab forms of B11b (the counterpart of B7's ghost-ref mode), B10a,
B8a and B8b (``ghosts=``: a z-slab of a domain decomposed along z over
ranks) in the port, on the CPU: the kernels of the meshed channel-form
solve and the meshed HCZ step.

* Each slab form's plain version against the TPU kernel's ghost mode,
  called directly in interpret mode on one device with the ghost planes
  given as arrays (no mesh), at an edge and an interior slab of 4: B11b
  against ``poisson_wavefront(ghosts=, emit_bands=True)`` (one pass of 3
  sweeps on 3-plane bands) with h in float32 and bfloat16; B10a against
  ``grad_fields(x, ghost_lo, ghost_hi)`` with its caller's fix (the x/y
  ring replicated on every slab, z at the domain's true edges only,
  ``parallel/step3d.py:grad_fields_sharded`` there) at 1 and 3 fields;
  B8a and B8b against their ``up_ghost``/``dn_ghost`` modes.  Bars: B11b
  rel <= 1e-6 in float32 (tests/test_torch_poisson.py's, the same
  ``_sweep_math``) and in bfloat16 each value within one bfloat16 ulp, at
  most 1e-3 of them apart (a float32 ulp of a sweep can round a stored
  value the other way: one of 7296 here), psi within what one such value
  moves, B10a rel <=
  1e-6 (the kernel multiplies by 1/(12 dx), the port divides), B8a and B8b
  f_post bit for bit (values moved, not computed) and the moments at the
  port's float32 contract, rel <= 5e-5, velocities also abs <= 5e-6.
* Split and reassemble: a domain cut into 2 and 4 slabs, each slab form's
  plain version fed the neighbours' planes, put back together, equals the
  single-device plain version bit for bit (every cell's arithmetic is the
  same): B11b over 30 sweeps in rounds of k = 1..4 (k = 4 ends with a
  remainder round of 2 sweeps on the same 4-plane bands), the bands each
  round emits exchanged before the next; B10a at 1 and 3 fields; B8a and
  B8b in float32 and bfloat16.
* The substitution trap: psi's obstacle substitution on a slab pads z only
  at the domain's true edges; a magnetic obstacle on an inner slab's face
  plane, with the x-edge ring cells there, takes the whole domain's
  values, where padding each slab's own faces would not.
* The round plan, and the wrappers' argument checks.
* B7's trailing stage on slabs (``emit="h2"``/``"hint"`` with ``clamp``):
  the slab form against the TPU wavefront's ghost mode with ``slab_clamp``
  and ``emit="h2"`` at an edge and an interior slab of 4 (rel <= 1e-6, the
  one-device bar of tests/test_torch_poisson_emit.py); split and
  reassembled (the rounds before the last as above, the last from bands of
  k_f + 1 planes, its clamp at the domain's true edges only) bit for bit to
  one device's emitting call, on 2 and 4 slabs; and the meshed solve
  (``solve_H_int`` with ``mesh``) on 2 gloo ranks of
  ``tests/torch_mesh_worker.py:h2_main`` bit for bit to one device, with k
  clamped by the last round's spare plane on 3-plane slabs and the psi
  route where the plan refuses the trailing stage.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lbm_ferrofluid_tpu.ops.pallas.poisson import poisson_wavefront as jwavefront  # noqa: E402
from lbm_ferrofluid_tpu.ops.pallas.stencil3d import grad_fields as jgrad  # noqa: E402
from lbm_ferrofluid_tpu.ops.pallas.stream3d import (  # noqa: E402
    stream_bounce_macro as jmacro,
)
from lbm_ferrofluid_tpu.ops.pallas.stream3d import (  # noqa: E402
    stream_bounce_moments as jmoments,
)

import torch_mesh_worker as worker  # noqa: E402
from lbm_ferrofluid_tpu_torch.lattice import D3Q19  # noqa: E402
from lbm_ferrofluid_tpu_torch.ops import solve_H_int  # noqa: E402
from lbm_ferrofluid_tpu_torch.ops.kernels import poisson, stencil3d, stream3d  # noqa: E402
from lbm_ferrofluid_tpu_torch.ops.kernels.fused_step import ghost_planes  # noqa: E402
from lbm_ferrofluid_tpu_torch.ops.stencils import (  # noqa: E402
    substitute_obstacles,
    substitute_obstacles_slab,
)
from lbm_ferrofluid_tpu_torch.parallel import Mesh, step3d  # noqa: E402

RES = (16, 8, 12)
OBS, FLUID = 2, 1
BF = torch.bfloat16
GAS = dict(rho_gas=0.02381, rho_fluid=0.2508, density_gas=0.02381, density_fluid=0.2508)


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
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) if t.dtype == BF else \
        jnp.asarray(t.numpy())


def cut(x, nz, i, lo=0, hi=0):
    """Slab i of nz along z, with ``lo`` planes below and ``hi`` above it
    (periodic)."""
    Z = x.shape[2]
    Zl = Z // nz
    idx = torch.arange(i * Zl - lo, (i + 1) * Zl + hi) % Z
    return x[:, :, idx]


def bands(x, nz, i, G):
    """The G planes of slab i's neighbours below and above it."""
    return cut(x, nz, i, G)[:, :, :G], cut(x, nz, i, 0, G)[:, :, -G:]


def clamp_of(nz, i):
    Zl = RES[0] // nz
    return (1 if i == 0 else -1, Zl - 2 if i == nz - 1 else Zl)


@pytest.fixture(scope="module")
def scene():
    """The Rosensweig magnetic shell (x-edge columns, z-edge planes) with a
    block of magnetic obstacles across the inner faces of 2 and 4 slabs,
    h, the source, psi-like fields, and f, g, rho and vel from the seed."""
    rng = np.random.default_rng(11)
    Z, Y, X = RES
    mf = np.full((1, 1, *RES), OBS, np.uint8)
    mf[..., 1:-1, :, 1:-1] = FLUID
    mf[..., [3, 4, 7, 8], 3:5, 5:7] = OBS
    flags = np.full((1, 1, *RES), OBS, np.uint8)
    flags[..., 1:-1, 1:-1, 1:-1] = FLUID
    rhs = (rng.uniform(-1e-2, 1e-2, (1, 1, *RES)) * (mf == FLUID)).astype(np.float32)
    f = rng.uniform(0.005, 0.02, (1, 19, *RES)).astype(np.float32)
    return dict(
        h=torch.from_numpy(rng.uniform(-0.1, 0.1, (1, 19, *RES)).astype(np.float32)),
        mflags=torch.from_numpy(mf), flags=torch.from_numpy(flags), rhs=torch.from_numpy(rhs),
        fields=torch.from_numpy(rng.standard_normal((1, 3, *RES)).astype(np.float32)),
        f=torch.from_numpy(f),
        rho=torch.from_numpy(rng.uniform(0.02, 0.26, (1, 1, *RES)).astype(np.float32)),
        vel=torch.from_numpy(rng.uniform(-0.01, 0.01, (1, 3, *RES)).astype(np.float32)),
    )


# ---------------------------------------------------------------------------
# against the TPU kernels' ghost modes (interpret mode, one device)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, BF], ids=["f32", "bf16"])
@pytest.mark.parametrize("i", [0, 1], ids=["edge", "interior"])
def test_poisson_slab_matches_wavefront_ghost_mode(scene, i, dtype):
    """One round of 3 sweeps on slab i of 4 (4 planes, 3-plane bands):
    h', psi and the two emitted bands against B7's ghost-ref mode."""
    nz, k = 4, 3
    h = scene["h"].to(dtype)
    hs, ghosts = cut(h, nz, i), bands(h, nz, i, k)
    f_ext, r_ext = cut(scene["mflags"], nz, i, k, k), cut(scene["rhs"], nz, i, k, k)
    jh, jpsi, (jlo, jhi) = jwavefront(J(hs), J(f_ext), J(r_ext), tau=0.8, n_iters=k,
                                      ghosts=tuple(J(b)[0] for b in ghosts), emit_bands=True,
                                      interpret=True)
    ph, ppsi, (plo, phi) = poisson.poisson_sweeps_plain(hs, f_ext, r_ext, tau=0.8, n_iters=k,
                                                        ghosts=ghosts, emit_bands=True)
    assert ph.dtype == plo.dtype == dtype and ppsi.dtype == torch.float32
    pairs = (("h", ph, jh), ("band_lo", plo[0], jlo), ("band_hi", phi[0], jhi))
    if dtype == torch.float32:
        for name, a, b in pairs + (("psi", ppsi, jpsi),):
            assert rel(a, b) <= 1e-6, name
        return
    for name, a, b in pairs:
        a, b = a.float().numpy(), np.asarray(b, np.float32)
        assert np.all(np.abs(a - b) <= 2.0 ** -7 * np.abs(b)), name
        assert np.count_nonzero(a != b) <= 1e-3 * a.size, name
    assert rel(ppsi, jpsi) <= 2.0 ** -7


@pytest.mark.parametrize("n_fields", [1, 3])
@pytest.mark.parametrize("i", [0, 1], ids=["edge", "interior"])
def test_grad_slab_matches_jax_with_its_fix(scene, i, n_fields):
    nz = 4
    x = scene["fields"][:, :n_fields]
    xs, ghosts = cut(x, nz, i), bands(x, nz, i, 1)
    want = np.array(jgrad(J(xs), J(ghosts[0]), J(ghosts[1]), dx=0.5, interpret=True))
    # the caller's fix (JAX grad_fields_sharded): x/y ring, then z at true edges
    for ax in (-1, -2):
        for a, b in ((0, 1), (-1, -2)):
            idx_a, idx_b = [slice(None)] * 5, [slice(None)] * 5
            idx_a[ax], idx_b[ax] = a, b
            want[tuple(idx_a)] = want[tuple(idx_b)]
    if i == 0:
        want[:, :, 0] = want[:, :, 1]
    got = stencil3d.grad_fields_plain(xs, ghosts, clamp_of(nz, i), dx=0.5)
    assert got.shape == (1, 3 * n_fields, RES[0] // nz, *RES[1:])
    assert rel(got, want) <= 1e-6


@pytest.mark.parametrize("i", [0, 1], ids=["edge", "interior"])
def test_stream_slabs_match_jax_ghost_modes(scene, i):
    nz = 4
    f, flags = scene["f"], scene["flags"]
    fs, fl = cut(f, nz, i), cut(flags, nz, i)
    up = ghost_planes(cut(f, nz, (i - 1) % nz))[0]
    dn = ghost_planes(cut(f, nz, (i + 1) % nz))[1]
    jm = jmoments(J(fs), J(fl), J(up), J(dn), interpret=True)
    pm = stream3d.stream_bounce_moments_plain(fs, fl, (up, dn))
    np.testing.assert_array_equal(pm[0].numpy(), np.asarray(jm[0]))
    for name, a, b in zip(("m0", "m1"), pm[1:], jm[1:]):
        close(name, a, b)
    rho_old, vel_old = cut(scene["rho"], nz, i), cut(scene["vel"], nz, i)
    jM = jmacro(J(fs), J(fl), J(rho_old), J(vel_old), J(up), J(dn), c=1.0, interpret=True,
                **GAS)
    pM = stream3d.stream_bounce_macro_plain(fs, fl, rho_old, vel_old, (up, dn), c=1.0, **GAS)
    np.testing.assert_array_equal(pM[0].numpy(), np.asarray(jM[0]))
    for name, a, b in zip(("rho", "vel", "density"), pM[1:], jM[1:]):
        close(name, a, b)


# ---------------------------------------------------------------------------
# split and reassemble, bit for bit
# ---------------------------------------------------------------------------

def _sweep_slabs(scene, nz, k, n_iters=30, dtype=torch.float32):
    """``n_iters`` sweeps on nz slabs in rounds of k (G = k band planes a
    side), then a remainder round on the same bands, as
    ``step3d.poisson_sweeps_sharded`` runs them: the gathered (h', psi)."""
    h = scene["h"].to(dtype)
    hs = [cut(h, nz, i) for i in range(nz)]
    ext = [(cut(scene["mflags"], nz, i, k, k), cut(scene["rhs"], nz, i, k, k))
           for i in range(nz)]
    gb = [bands(h, nz, i, k) for i in range(nz)]
    rounds = [k] * (n_iters // k) + [n_iters % k] * (n_iters % k > 0)
    for kk in rounds[:-1]:
        outs = [poisson.poisson_sweeps_plain(hs[i], *ext[i], tau=0.8, n_iters=kk, ghosts=gb[i],
                                             emit_bands=True, emit_psi=False)
                for i in range(nz)]
        assert all(o[1] is None for o in outs)
        hs = [o[0] for o in outs]
        gb = [(outs[(i - 1) % nz][2][1], outs[(i + 1) % nz][2][0]) for i in range(nz)]
    outs = [poisson.poisson_sweeps_plain(hs[i], *ext[i], tau=0.8, n_iters=rounds[-1],
                                         ghosts=gb[i]) for i in range(nz)]
    return tuple(torch.cat([o[j] for o in outs], dim=2) for j in (0, 1))


@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("nz", [2, 4])
def test_poisson_split_reassembles(scene, nz, k):
    whole = poisson.poisson_sweeps_plain(scene["h"], scene["mflags"], scene["rhs"], tau=0.8,
                                         n_iters=30)
    got = _sweep_slabs(scene, nz, k)
    assert torch.equal(got[0], whole[0]) and torch.equal(got[1], whole[1])


def test_poisson_split_reassembles_bf16(scene):
    whole = poisson.poisson_sweeps_plain(scene["h"].to(BF), scene["mflags"], scene["rhs"],
                                         tau=0.8, n_iters=30)
    got = _sweep_slabs(scene, 4, 3, dtype=BF)
    assert got[0].dtype == BF
    assert torch.equal(got[0], whole[0]) and torch.equal(got[1], whole[1])


@pytest.mark.parametrize("n_fields", [1, 3])
@pytest.mark.parametrize("nz", [2, 4])
def test_grad_split_reassembles(scene, nz, n_fields):
    x = scene["fields"][:, :n_fields]
    whole = stencil3d.grad_fields_plain(x, dx=0.5)
    parts = [stencil3d.grad_fields_plain(cut(x, nz, i), bands(x, nz, i, 1), clamp_of(nz, i),
                                         dx=0.5) for i in range(nz)]
    assert torch.equal(torch.cat(parts, dim=2), whole)


@pytest.mark.parametrize("dtype", [torch.float32, BF], ids=["f32", "bf16"])
@pytest.mark.parametrize("nz", [2, 4])
def test_stream_split_reassembles(scene, nz, dtype):
    f, flags, rho, vel = scene["f"].to(dtype), scene["flags"], scene["rho"], scene["vel"]

    def ghosts(i):
        return (ghost_planes(cut(f, nz, (i - 1) % nz))[0],
                ghost_planes(cut(f, nz, (i + 1) % nz))[1])

    whole = stream3d.stream_bounce_moments_plain(f, flags)
    parts = [stream3d.stream_bounce_moments_plain(cut(f, nz, i), cut(flags, nz, i), ghosts(i))
             for i in range(nz)]
    for j, w in enumerate(whole):
        assert torch.equal(torch.cat([p[j] for p in parts], dim=2), w), j
    whole = stream3d.stream_bounce_macro_plain(f, flags, rho, vel, c=1.0, **GAS)
    parts = [stream3d.stream_bounce_macro_plain(
        cut(f, nz, i), cut(flags, nz, i), cut(rho, nz, i), cut(vel, nz, i), ghosts(i), c=1.0,
        **GAS) for i in range(nz)]
    for j, w in enumerate(whole):
        assert torch.equal(torch.cat([p[j] for p in parts], dim=2), w), j


# ---------------------------------------------------------------------------
# the substitution trap, the plan, the arguments
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nz", [2, 4])
def test_obstacle_substitution_pads_true_edges_only(scene, nz):
    """psi's obstacle substitution, slab by slab, equals the whole
    domain's: the obstacle block on the inner face planes and the x-edge
    ring cells of every face plane take their own plane's interior value;
    padding each slab's faces (``substitute_obstacles`` on the slab) moves
    them a plane inward and differs there."""
    psi, mf = scene["fields"][:, :1], scene["mflags"]
    whole = substitute_obstacles(psi, mf)
    parts = [substitute_obstacles_slab(cut(psi, nz, i), cut(mf, nz, i), (i == 0, i == nz - 1))
             for i in range(nz)]
    assert torch.equal(torch.cat(parts, dim=2), whole)
    naive = torch.cat([substitute_obstacles(cut(psi, nz, i), cut(mf, nz, i))
                       for i in range(nz)], dim=2)
    Zl = RES[0] // nz
    differ = (naive != whole)[0, 0]
    assert differ.any() and set(differ.nonzero()[:, 0].tolist()) <= {
        z for i in range(1, nz) for z in (i * Zl - 1, i * Zl)}
    assert differ[Zl - 1, 0, 0] and differ[Zl, 3, 5]


def _mesh(nz, slab=False):
    return Mesh(("batch", "z"), (1, nz), 0, torch.device("cpu"), "gloo" if nz > 1 else None,
                slab)


def test_channel_slab_plan():
    """k <= MAX_K sweeps a round with G = k <= Zl and the remainder; None
    where h is not 19-channel or Z does not split; every k, G = k."""
    for nz, Z, n in ((2, 256, 30), (2, 130, 30), (4, 16, 6), (1, 256, 30), (4, 16, 30)):
        plan = step3d.channel_slab_plan(_mesh(nz, slab=nz == 1), (1, 19, Z, 66, 130), n)
        k, G, r = plan
        assert 1 <= k <= poisson.MAX_K and G == k <= Z // nz and r == n % k
    assert step3d.channel_slab_plan(_mesh(2), (1, 2, 16, 8, 8), 30) is None
    assert step3d.channel_slab_plan(_mesh(3), (1, 19, 16, 8, 8), 30) is None
    assert step3d.channel_slab_plan(_mesh(8), (1, 19, 16, 8, 8), 30)[0] <= 2
    assert step3d.channel_sharded_ok(_mesh(2), (1, 19, 16, 8, 8), 30)
    assert not step3d.channel_sharded_ok(_mesh(3), (1, 19, 16, 8, 8), 30)


def test_slab_wrappers_refuse_partial_arguments(scene):
    """B10a's ghosts come with a clamp; B11b's bands and psi options are the
    slab form's, its round at most ``MAX_K`` sweeps and at most G; the
    costs count the bands and ghost planes."""
    nz, i = 4, 1
    x = scene["fields"][:, :1]
    with pytest.raises(ValueError, match="ghosts and clamp together"):
        stencil3d.grad_fields(cut(x, nz, i), bands(x, nz, i, 1))
    h = scene["h"]
    with pytest.raises(ValueError, match="slab form's"):
        poisson.poisson_sweeps(h, scene["mflags"], scene["rhs"], tau=0.8, n_iters=3,
                               emit_bands=True)
    hs = cut(h, nz, i).to("meta")
    args = (hs, torch.empty((1, 1, 10, *RES[1:]), dtype=torch.uint8, device="meta"),
            torch.empty((1, 1, 10, *RES[1:]), device="meta"))
    gb = tuple(torch.empty((1, 19, 3, *RES[1:]), device="meta") for _ in range(2))
    with pytest.raises(ValueError, match="1 <= k <= G <= Zl"):
        poisson._check_slab(*args, gb, 4)
    nbytes, flops = poisson.cost_slab(cut(h, nz, i), *args[1:], tau=0.8, n_iters=30,
                                      rounds=(4,) * 7 + (2,), G=4)
    plane = RES[1] * RES[2]
    assert nbytes == ((2 * 76 + 4) * 4 + 5 * 12 + 2 * 4 * 76 * 15) * plane
    assert flops == 78 * plane * (7 * (10 + 8 + 6 + 4) + (6 + 4))
    assert stencil3d.cost_slab(cut(x, nz, i), clamp=(-1, 4))[0] == 16 * 4 * plane + 8 * plane
    b8 = stream3d.cost_slab(stream3d.cost_moments, cut(scene["f"], nz, i),
                            cut(scene["flags"], nz, i), ghosts=bands(scene["f"][:, 9:14], nz,
                                                                    i, 1))
    assert b8[0] == stream3d.cost_moments(cut(scene["f"], nz, i), cut(scene["flags"], nz, i))[
        0] + 2 * 5 * 4 * plane


def test_slab_pass_instances_are_the_cuda_sources():
    """``SLAB_EXT_HEIGHTS`` is csrc/poisson.cu's PP_SLAB_HEIGHTS, the
    extended heights the slab kernel is built for, and the slab pass of
    every k of 1..``MAX_K`` in float32 and bfloat16 is among them (k = 4 in
    float32 on 5-row tiles, whose block fits the shared memory)."""
    import re
    from pathlib import Path

    src = (Path(poisson.__file__).parents[2] / "csrc" / "poisson.cu").read_text()
    line = re.search(r"#define PP_SLAB_HEIGHTS\(M\) (.*)", src)[1]
    assert tuple(int(e) for e in re.findall(r"M\((\d+)\)", line)) == poisson.SLAB_EXT_HEIGHTS
    assert set(poisson.SLAB_EXT_HEIGHTS) <= set(poisson.EXT_HEIGHTS)
    for k in range(1, poisson.MAX_K + 1):
        for elem in (4, 2):
            pl = poisson.slab_plan(128, 256, 256, k, 132, elem)
            assert pl.passes == (k,) and pl.ty + 2 * k - 2 in poisson.SLAB_EXT_HEIGHTS
            assert poisson.smem_bytes(k, pl.ty, elem) <= poisson.SMEM_BLOCK_MAX
    assert poisson.slab_plan(128, 256, 256, 4, 132, 4).ty == 5


# ---------------------------------------------------------------------------
# B7's trailing stage on slabs
# ---------------------------------------------------------------------------

H_EXT = (0.0, 85.0, 0.0)


@pytest.mark.parametrize("i", [0, 1], ids=["edge", "interior"])
def test_trail_slab_matches_wavefront_slab_clamp(scene, i):
    """One round of 3 sweeps on slab i of 4 with 4-plane bands and H2: the
    TPU wavefront's ghost mode with ``emit="h2"`` and its ``slab_clamp``
    (extended coordinates: G + 1 at the domain's bottom, else 1)."""
    nz, k, G = 4, 3, 4
    Zl = RES[0] // nz
    hs, ghosts = cut(scene["h"], nz, i), bands(scene["h"], nz, i, G)
    f_ext, r_ext = cut(scene["mflags"], nz, i, G, G), cut(scene["rhs"], nz, i, G, G)
    clamp = clamp_of(nz, i)
    jclamp = jnp.asarray([G + 1 if i == 0 else 1, Zl + 2 * G - 2], jnp.int32)
    _, jh2 = jwavefront(J(hs), J(f_ext), J(r_ext), tau=0.8, n_iters=k, emit="h2", dx=1.0,
                        h_ext=H_EXT, slab_clamp=jclamp, ghosts=tuple(J(b)[0] for b in ghosts),
                        interpret=True)
    ph, ph2 = poisson.poisson_sweeps_plain(hs, f_ext, r_ext, tau=0.8, n_iters=k, ghosts=ghosts,
                                           emit="h2", h_ext=H_EXT, clamp=clamp)
    assert ph2.shape == (1, 1, Zl, *RES[1:])
    assert rel(ph2, jh2) <= 1e-6


def _trail_slabs(scene, nz, k, n_iters, emit):
    """``n_iters`` sweeps on nz slabs as ``step3d.poisson_sweeps_sharded``
    runs them with the trailing stage: rounds of k on k-plane bands (the
    round before the last emits none), then the last round of k_f sweeps
    on the neighbours' k_f + 1 nearest planes of h, flags and rhs extended
    by the larger band; the gathered (h', H_int or H2)."""
    rounds = [k] * (n_iters // k) + [n_iters % k] * (n_iters % k > 0)
    G, G_f = k, rounds[-1] + 1
    Ge = max(G, G_f)
    hs = [cut(scene["h"], nz, i) for i in range(nz)]
    ext = [(cut(scene["mflags"], nz, i, Ge, Ge), cut(scene["rhs"], nz, i, Ge, Ge))
           for i in range(nz)]

    def sl(i, g):
        return tuple(x[:, :, Ge - g:x.shape[2] - Ge + g] for x in ext[i])

    def edge_bands(g):
        whole = torch.cat(hs, dim=2)
        return [bands(whole, nz, i, g) for i in range(nz)]

    gb = edge_bands(G)
    for j, kk in enumerate(rounds[:-1]):
        last = j == len(rounds) - 2
        outs = [poisson.poisson_sweeps_plain(hs[i], *sl(i, G), tau=0.8, n_iters=kk, ghosts=gb[i],
                                             emit_bands=not last, emit_psi=False)
                for i in range(nz)]
        hs = [o[0] for o in outs]
        if not last:
            gb = [(outs[(i - 1) % nz][2][1], outs[(i + 1) % nz][2][0]) for i in range(nz)]
    gb = edge_bands(G_f)
    outs = [poisson.poisson_sweeps_plain(hs[i], *sl(i, G_f), tau=0.8, n_iters=rounds[-1],
                                         ghosts=gb[i], emit=emit, dx=0.5,
                                         h_ext=H_EXT if emit == "h2" else None,
                                         clamp=clamp_of(nz, i))
            for i in range(nz)]
    return tuple(torch.cat([o[j] for o in outs], dim=2) for j in (0, 1))


@pytest.mark.parametrize("emit", ["h2", "hint"])
@pytest.mark.parametrize("nz,k,n_iters", [(2, 3, 6), (2, 2, 7), (4, 3, 6), (4, 3, 7)])
def test_trail_split_reassembles(scene, nz, k, n_iters, emit):
    whole = poisson.poisson_sweeps_plain(scene["h"], scene["mflags"], scene["rhs"], tau=0.8,
                                         n_iters=n_iters, emit=emit, dx=0.5,
                                         h_ext=H_EXT if emit == "h2" else None)
    got = _trail_slabs(scene, nz, k, n_iters, emit)
    assert torch.equal(got[0], whole[0]) and torch.equal(got[1], whole[1])


@pytest.fixture(scope="module")
def meshed_h2(tmp_path_factory):
    return worker.run_h2(2, tmp_path_factory.mktemp("h2"), worker.H2_CASES)


@pytest.mark.parametrize("case", sorted(worker.H2_CASES))
def test_meshed_h2_solve_bit_for_bit(meshed_h2, case):
    """2 gloo ranks: (H2, h') gathered equal one device's ``solve_H_int``
    bit for bit; the route as the plan says: the trailing stage on every
    case but the one without an interior row (where B10a's slab form runs),
    and k clamped on 3-plane slabs (the last round's G_f = k_f + 1 <=
    Zl)."""
    H2, h, emitted, (k_h2, k_psi) = meshed_h2[case]
    res, n = worker.H2_CASES[case]
    h0, mf, rhs = (torch.from_numpy(a) for a in worker.h2_inputs(res))
    wH2, wh = solve_H_int(D3Q19, h0, None, mf, None, tau=0.8, n_iters=n, rhs_scaled=rhs,
                          h2_ext=worker.H2_FIELD)
    np.testing.assert_array_equal(h, wh.numpy())
    np.testing.assert_array_equal(H2, wH2.numpy())
    assert emitted == [case != "psi_route"] * 2
    assert (k_h2, k_psi) == {"h2": (3, 3), "clamped": (2, 3), "remainder": (4, 4),
                             "psi_route": (0, 3)}[case]


def test_channel_h2_plan():
    """The plan of the emitting solve: the last round's k_f sweeps read
    k_f + 1 <= Zl band planes and k_f <= ``TRAIL_MAX_K`` (a k that breaks it
    is dropped), the rounds before it as the psi plan's; None where the
    output has no interior row or column."""
    for nz, Z, n in ((2, 256, 30), (2, 130, 30), (4, 16, 6), (4, 16, 7), (2, 6, 30),
                     (4, 8, 30), (1, 256, 30)):
        mesh = _mesh(nz, slab=nz == 1)
        k, G, r = step3d.channel_slab_plan(mesh, (1, 19, Z, 66, 130), n, h2=True)
        k_f = r or k
        assert G == k <= Z // nz and k_f + 1 <= Z // nz and k_f <= poisson.TRAIL_MAX_K
    # 3-plane slabs: k = 3 (the psi plan's) would leave no spare plane
    assert step3d.channel_slab_plan(_mesh(2), (1, 19, 6, 8, 8), 6)[0] == 3
    assert step3d.channel_slab_plan(_mesh(2), (1, 19, 6, 8, 8), 6, h2=True)[0] == 2
    assert step3d.channel_slab_plan(_mesh(2), (1, 19, 16, 2, 8), 6, h2=True) is None
    assert step3d.channel_slab_plan(_mesh(2), (1, 19, 16, 8, 2), 6, h2=True) is None


def test_cost_slab_counts_the_last_rounds_bands(scene):
    """With the trailing stage the last round reads G_f = k_f + 1 band
    planes a side from h and the round before it writes none; H2 is written
    where psi was, H_int's three channels take 8 B a cell more; the last
    round's sweeps reach one plane further a side."""
    nz, i = 4, 1
    hs = cut(scene["h"], nz, i)
    Zl, plane = RES[0] // nz, RES[1] * RES[2]
    args = (hs, cut(scene["mflags"], nz, i, 4, 4), cut(scene["rhs"], nz, i, 4, 4))
    kw = dict(tau=0.8, n_iters=6, rounds=(3, 3), G=3, clamp=(-1, Zl), h_ext=H_EXT)
    psi = poisson.cost_slab(*args, **{k: v for k, v in kw.items() if k in ("tau", "n_iters",
                                                                             "rounds", "G")})
    h2 = poisson.cost_slab(*args, emit="h2", **kw)
    hint = poisson.cost_slab(*args, emit="hint", **kw)
    band = 19 * 4 * plane
    # psi: reads 3 + 3 planes a side, writes 3; h2: reads 3 + 4, writes none
    assert h2[0] - psi[0] == band * 2 * (1 - 3) + 5 * 2 * plane
    assert hint[0] - h2[0] == 8 * Zl * plane
    interior = Zl * (RES[1] - 2) * (RES[2] - 2)
    assert h2[1] - psi[1] == 78 * plane * 2 * 3 + (33 + 6) * interior


# ---------------------------------------------------------------------------
# flags and rhs as the slab's own planes with their bands (``aux_ghosts``)
# ---------------------------------------------------------------------------

def aux_bands(scene, nz, i, GA):
    """The neighbours' GA nearest planes of the flags and rhs below and
    above slab i: ((flags_lo, rhs_lo), (flags_hi, rhs_hi))."""
    (flo, fhi), (rlo, rhi) = (bands(scene[key], nz, i, GA) for key in ("mflags", "rhs"))
    return (flo, rlo), (fhi, rhi)


BANDED = [(k, emit, dtype, i) for k in (1, 2, 3, 4) for emit in ("psi", "h2", "hint")
          for dtype in (torch.float32, BF) for i in (0, 1)
          if emit == "psi" or k <= poisson.TRAIL_MAX_K]


@pytest.mark.parametrize("k,emit,dtype,i", BANDED, ids=[
    f"k{k}-{emit}-{'bf16' if d == BF else 'f32'}-{'edge' if i == 0 else 'interior'}"
    for k, emit, d, i in BANDED])
def test_plain_banded_equals_extended(scene, k, emit, dtype, i):
    """One round of k sweeps on slab i of 4: the plain version fed the
    slab's own flags and rhs with bands one plane deeper than h's (the
    round reads their nearest G) equals it fed the extended pair, bit for
    bit, in every output (h', psi or H2 or H_int, the emitted bands)."""
    nz = 4
    G = k + (emit != "psi")
    h = scene["h"].to(dtype)
    hs, ghosts = cut(h, nz, i), bands(h, nz, i, G)
    kw = dict(tau=0.8, n_iters=k, ghosts=ghosts)
    if emit == "psi":
        kw.update(emit_bands=True)
    else:
        kw.update(emit=emit, dx=0.5, h_ext=H_EXT if emit == "h2" else None,
                  clamp=clamp_of(nz, i))
    ext = poisson.poisson_sweeps_plain(hs, cut(scene["mflags"], nz, i, G, G),
                                       cut(scene["rhs"], nz, i, G, G), **kw)
    got = poisson.poisson_sweeps_plain(hs, cut(scene["mflags"], nz, i), cut(scene["rhs"], nz, i),
                                       aux_ghosts=aux_bands(scene, nz, i, G + 1), **kw)
    flat = [ext[0], ext[1], *(ext[2] if emit == "psi" else ())]
    assert len(got) == len(ext)
    for a, b in zip([got[0], got[1], *(got[2] if emit == "psi" else ())], flat, strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_slab_wrappers_refuse_partial_band_arguments(scene):
    """``aux_ghosts`` is the slab form's, a (flags, rhs) pair a side, each
    band uint8 or float32 of [1, 1, GA, Y, X] with GA >= G on both sides,
    beside the slab's own flags and rhs; the extended pair keeps Zl + 2G
    planes.  The plain version and the kernel's wrapper refuse the rest
    with the argument named."""
    nz, i, G = 4, 1, 3
    h = scene["h"]
    hs, ghosts = cut(h, nz, i), bands(h, nz, i, G)
    mf, rhs = cut(scene["mflags"], nz, i), cut(scene["rhs"], nz, i)
    good = aux_bands(scene, nz, i, G)
    (flo, rlo), (fhi, rhi) = good
    kw = dict(tau=0.8, n_iters=3, ghosts=ghosts)
    with pytest.raises(ValueError, match="aux_ghosts are the slab form's"):
        poisson.poisson_sweeps(h, scene["mflags"], scene["rhs"], tau=0.8, n_iters=3,
                               aux_ghosts=good)
    for partial in ((good[0],), (good[0], None), ((flo, rlo), (fhi,)), (flo, fhi),
                    ((flo, rlo, rlo), (fhi, rhi))):
        with pytest.raises(ValueError, match=r"a \(flags, rhs\) pair a side"):
            poisson.poisson_sweeps(hs, mf, rhs, aux_ghosts=partial, **kw)
    wrong = {
        "flags_lo": ((flo.float(), rlo), (fhi, rhi)),
        "rhs_hi": ((flo, rlo), (fhi, rhi[..., :-1])),
        "flags_hi": ((flo, rlo), (fhi[:, :, :2], rhi)),
        "rhs_lo": ((flo, rlo.double()), (fhi, rhi)),
    }
    for name, aux in wrong.items():
        with pytest.raises(ValueError, match=f"{name} must be"):
            poisson.poisson_sweeps(hs, mf, rhs, aux_ghosts=aux, **kw)
    with pytest.raises(ValueError, match="magnetic_flags must be"):
        poisson.poisson_sweeps(hs, cut(scene["mflags"], nz, i, G, G), rhs, aux_ghosts=good, **kw)
    with pytest.raises(ValueError, match="rhs_scaled must be"):
        poisson.poisson_sweeps(hs, cut(scene["mflags"], nz, i, G, G), rhs, **kw)
    shallow = aux_bands(scene, nz, i, G - 1)
    with pytest.raises(ValueError, match="fewer than the G = 3 planes"):
        poisson.poisson_sweeps(hs, mf, rhs, aux_ghosts=shallow, **kw)
    meta = tuple(tuple(t.to("meta") for t in side) for side in good)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        poisson._check_slab(hs.to("meta"), mf.to("meta"), rhs.to("meta"),
                            tuple(g.to("meta") for g in ghosts), 3, meta)


@pytest.mark.parametrize("banded", [False, True], ids=["extended", "banded"])
def test_slab_flags_rhs_pointers(scene, banded):
    """The slab launch's flags and rhs pointers (the slab's planes, then
    flo, fhi, rlo, rhi) and the band depth GA it passes: the extended
    pair's planes [G, G + Zl), [0, G) and [G + Zl, Zl + 2G) with GA = G, or
    the caller's tensors and bands themselves with their own depth."""
    nz, i, G = 4, 1, 3
    Zl = RES[0] // nz
    hs = cut(scene["h"], nz, i)
    if banded:
        mf, rhs = cut(scene["mflags"], nz, i), cut(scene["rhs"], nz, i)
        aux = aux_bands(scene, nz, i, G + 2)
        (flo, rlo), (fhi, rhi) = aux
        want = (mf, rhs, flo, fhi, rlo, rhi)
    else:
        mf, rhs = cut(scene["mflags"], nz, i, G, G), cut(scene["rhs"], nz, i, G, G)
        aux = None
        want = (mf[:, :, G:], rhs[:, :, G:], mf, mf[:, :, G + Zl:], rhs, rhs[:, :, G + Zl:])
    assert poisson._aux_depth(hs, mf, rhs, G, aux) == (G + 2 if banded else G)
    got = poisson._flags_rhs_ptrs(mf, rhs, G, Zl, aux)
    assert [p.value for p in got] == [t.data_ptr() for t in want]
