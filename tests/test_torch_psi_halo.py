"""The meshed solves' two exchange options in the port (ROADMAP B-8 and the
shell sliver), on the CPU: ``poisson_psi_halo`` (the channel-form solve's
bands after the first round rebuilt from the neighbours' psi at tau == 1,
``parallel/step3d.py:poisson_sweeps_sharded``, ``ops/kernels/psi_halo.py``)
and ``scalar_sliver`` (the scalar carry's s_prev bands sent as the shell's
sliver, ``step3d.scalar_poisson_sharded``), each under the
``mag_flags_shell`` declaration.

* Split and reassemble, in one process: the ranks of a z mesh are threads
  whose ``ring_halo`` hands each exchange to its neighbour thread
  (:class:`ThreadRing`), so the solve under test is the port's own.  On
  16x8x16 with the shell's magnetic obstacles at tau 1, the psi-refreshed
  solve on 2 and 4 slabs equals the full-h solve bit for bit, and so one
  device's: k = 1..4 sweeps a round, 7 sweeps (a remainder round) and 30,
  psi out and the h2 final round, float32 and (k = 3) bfloat16.  The sliver
  equals the full band bit for bit but for the sign of a zero.
* The plain reconstruction (:func:`psi_halo.psi_ghost_band_plain`) equals
  the neighbour's stored planes bit for bit, bands of both sides, float32
  and bfloat16.
* Against JAX: the port's psi route within JAX's own bars of its
  ``poisson_sweeps_sharded(psi_halo=True, interpret=True)`` on the 8-device
  host mesh (rel <= 3e-6 in float32; in bfloat16 rel <= 2e-2 with at most
  1e-3 of the values apart, tests/test_sharded_step.py:93-130, the float32
  psi and H2 apart where they differ beyond the float32 bar), with and
  without ``emit_h2``; the sliver solve within JAX's bars of its
  ``scalar_poisson_sharded(shell_sliver=True)``.
* The gates: ``poisson_psi_halo=False``, tau != 1, no shell declaration and
  G == Zl keep the full-h exchange; the step passes each option only under
  the shell declaration, which priming on slabs checks over the whole
  domain.
* On gloo ranks (``tests/torch_mesh_worker.py:run_psi``, one spawn of 4
  ranks on (batch, z) = (2, 2), each element on 2 z ranks): the bytes
  (``ring_halo.sent_bytes``) and exchanges (``ring_halo.exchanges``) of
  each option equal the counted formula; the Rosensweig scene's flagship
  at tau 1 without the scalar carry, primed (route C) and un-primed (U19)
  at B = 2, bit for bit to one device and to ``poisson_psi_halo=False``,
  and within tests/test_torch_parallel_channel.py's JAX bars (rtol 2e-5,
  atol 1e-6).
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

#: records the ids of the tests this process runs, for a mismatch's record
#: (``torch_mesh_worker.save_sides``)
pytest_plugins = ["torch_test_log"]

torch = pytest.importorskip("torch")

from lbm_ferrofluid_tpu import models as jmodels  # noqa: E402
from lbm_ferrofluid_tpu.parallel import step3d as jstep3d  # noqa: E402
from lbm_ferrofluid_tpu.parallel.mesh import make_mesh as jmake_mesh  # noqa: E402

import torch_mesh_worker as worker  # noqa: E402
from lbm_ferrofluid_tpu_torch.ops.kernels import poisson, psi_halo  # noqa: E402
from lbm_ferrofluid_tpu_torch.ops.kernels.scalar_poisson import (  # noqa: E402
    scalar_wavefront_plain,
)
from lbm_ferrofluid_tpu_torch.ops.scalar_poisson import make_cmask  # noqa: E402
from lbm_ferrofluid_tpu_torch.parallel import Mesh, step3d  # noqa: E402

RES = (16, 8, 16)
OBS, FLUID = 2, 1
BF = torch.bfloat16
H_EXT = (0.0, 85.0, 0.0)


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class ThreadRing:
    """``ring_halo`` between threads, one a rank of a z mesh: each exchange
    leaves its tensor for the neighbour ``shift`` steps up and takes the one
    the neighbour ``shift`` steps down left at the same count of exchanges;
    counts each rank's exchanges and bytes as ``ring_halo`` does."""

    def __init__(self):
        self.cv = threading.Condition()
        self.box, self.count, self.sent = {}, {}, {}

    def __call__(self, x, mesh, shift, axis="z"):
        me, dst = mesh.rank, mesh.rank_at(**{axis: mesh.coords[axis] + shift})
        x = x.contiguous().clone()
        with self.cv:
            n = self.count.get(me, 0)
            self.count[me] = n + 1
            self.sent[me] = self.sent.get(me, 0) + x.nbytes
            self.box[(dst, n)] = x
            self.cv.notify_all()
            if not self.cv.wait_for(lambda: (me, n) in self.box, timeout=120):
                raise TimeoutError(f"rank {me}: exchange {n} never arrived")
            got = self.box.pop((me, n))
        # ring_halo receives into a tensor of what it sends
        assert (got.shape, got.dtype) == (x.shape, x.dtype), f"rank {me}: exchange {n}"
        return got


def on_ranks(nz, fn, monkeypatch):
    """``fn(mesh, ring)`` on the nz ranks of a ("batch", "z") = (1, nz) mesh,
    each rank a thread; returns (the ranks' results, the ring)."""
    ring = ThreadRing()
    monkeypatch.setattr(step3d, "ring_halo", ring)
    meshes = [Mesh(("batch", "z"), (1, nz), r, torch.device("cpu"), "gloo") for r in range(nz)]
    out, errors = [None] * nz, []

    def run(r):
        try:
            out[r] = fn(meshes[r])
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(r,)) for r in range(nz)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return out, ring


def cut(x, nz, i):
    Zl = x.shape[2] // nz
    return x[:, :, i * Zl:(i + 1) * Zl].contiguous()


def gather(parts, j):
    return torch.cat([p[j] for p in parts], dim=2)


@pytest.fixture(scope="module")
def scene():
    """The shell's magnetic obstacles (x-edge columns, z-edge planes), h
    and the source from the seed (the source zero at obstacles)."""
    rng = np.random.default_rng(25)
    mf = np.full((1, 1, *RES), OBS, np.uint8)
    mf[..., 1:-1, :, 1:-1] = FLUID
    h = rng.uniform(-0.1, 0.1, (1, 19, *RES)).astype(np.float32)
    rhs = (rng.uniform(-1e-2, 1e-2, (1, 1, *RES)) * (mf == FLUID)).astype(np.float32)
    return dict(h=torch.from_numpy(h), mf=torch.from_numpy(mf), rhs=torch.from_numpy(rhs))


def solve(scene, nz, monkeypatch, *, n_iters, k=None, dtype=torch.float32, emit=False,
          psi=True, tau=1.0):
    """The port's meshed channel-form solve on nz thread ranks (k sweeps a
    round where given: ``step3d.MAX_K``, the round's cost the larger part at
    this grid); returns the gathered (h', psi or H2) and the ring."""
    if k is not None:
        monkeypatch.setattr(step3d, "MAX_K", k)
    h = scene["h"].to(dtype)

    def rank(mesh):
        args = (cut(h, nz, mesh.iz), cut(scene["mf"], nz, mesh.iz),
                cut(scene["rhs"], nz, mesh.iz), mesh)
        return step3d.poisson_sweeps_sharded(*args, tau=tau, n_iters=n_iters,
                                             emit_h2=H_EXT if emit else None, psi_halo=psi)

    parts, ring = on_ranks(nz, rank, monkeypatch)
    if emit:
        assert all(p[2] for p in parts)
    return (gather(parts, 0), gather(parts, 1)), ring


def planned(mesh, n_iters, emit, k=None, res=RES):
    """(rounds, band depths) of the channel-form solve's plan on ``mesh``
    (k sweeps a round at most where given)."""
    real = step3d.MAX_K
    step3d.MAX_K = k or real
    try:
        rounds, depth, emitted = step3d.channel_slab_rounds(mesh, (1, 19, *res), n_iters,
                                                            h2=emit)
    finally:
        step3d.MAX_K = real
    assert emitted == emit
    return rounds, depth


def z_mesh(nz, rank=0):
    return Mesh(("batch", "z"), (1, nz), rank, torch.device("cpu"), "gloo")


# ---------------------------------------------------------------------------
# split and reassemble, bit for bit
# ---------------------------------------------------------------------------

SPLIT = [(nz, k, n, emit, torch.float32) for nz in (2, 4) for k in (1, 2, 3, 4)
         for n in (7, 30) for emit in (False, True)] + [
    (nz, 3, n, emit, BF) for nz in (2, 4) for n in (7, 30) for emit in (False, True)]


@pytest.mark.parametrize("nz,k,n_iters,emit,dtype", SPLIT, ids=[
    f"nz{nz}-k{k}-n{n}-{'h2' if e else 'psi'}-{'bf16' if d == BF else 'f32'}"
    for nz, k, n, e, d in SPLIT])
def test_psi_refresh_bit_for_bit(scene, monkeypatch, nz, k, n_iters, emit, dtype, tmp_path):
    """The psi-refreshed solve equals the full-h solve and one device's
    call bit for bit, and sends no more bytes (fewer wherever a band of 2
    or more planes short of the slab is rebuilt)."""
    on, ring_on = solve(scene, nz, monkeypatch, n_iters=n_iters, k=k, dtype=dtype, emit=emit)
    off, ring_off = solve(scene, nz, monkeypatch, n_iters=n_iters, k=k, dtype=dtype, emit=emit,
                          psi=False)
    sides = ("h", "psi or H2")
    with worker.keep_mismatch(tmp_path, "psi on vs off", dict(zip(sides, on)),
                              dict(zip(sides, off))):
        assert torch.equal(on[0], off[0]) and torch.equal(on[1], off[1])
    kw = dict(emit="h2", h_ext=H_EXT) if emit else {}
    whole = poisson.poisson_sweeps_plain(scene["h"].to(dtype), scene["mf"], scene["rhs"],
                                         tau=1.0, n_iters=n_iters, **kw)
    with worker.keep_mismatch(tmp_path, "psi on vs one device", dict(zip(sides, on)),
                              dict(zip(sides, whole))):
        assert torch.equal(on[0], whole[0]) and torch.equal(on[1], whole[1])
    assert ring_on.count == ring_off.count
    rounds, depth = planned(z_mesh(nz), n_iters, emit, k)
    refreshed = any(step3d.psi_refresh_ok(1.0, g, RES[0] // nz) for g in depth[1:])
    assert (ring_on.sent[0] < ring_off.sent[0]) == refreshed
    assert ring_on.sent[0] <= ring_off.sent[0]


def psi_bytes(G, Y, X, e):
    """Bytes of one packed band: psi of G - 1 planes, one 19-channel plane,
    two columns of 19 channels of G - 1 planes."""
    return 4 * (G - 1) * Y * X + 19 * Y * X * e + 19 * (G - 1) * Y * 2 * e


def channel_bytes(mesh, n_iters, emit, e, psi, k=None, res=RES):
    """(bytes, exchanges) a rank sends in one channel-form solve: the flags
    (as float32) and the source extended once, one exchange a side; the
    first round's full bands; each later round's bands, rebuilt from psi
    where the refresh holds; two exchanges a round either way."""
    Z, Y, X = res
    Zl = Z // mesh.nz
    rounds, depth = planned(mesh, n_iters, emit, k, res)
    nbytes = 2 * 8 * max(depth) * Y * X + 2 * 19 * depth[0] * Y * X * e
    for g in depth[1:]:
        refresh = psi and step3d.psi_refresh_ok(1.0, g, Zl)
        nbytes += 2 * (psi_bytes(g, Y, X, e) if refresh else 19 * g * Y * X * e)
    return nbytes, 2 + 2 * len(rounds)


def scalar_bytes(mesh, n_iters, sliver, res=RES):
    """(bytes, exchanges) a rank sends in one scalar solve: cmask and the
    source extended once, then the (s, s_prev) bands of every round, as
    slivers (s whole, s_prev's 2 columns and its planes at global z = 1,
    Z - 2) or whole."""
    Z, Y, X = res
    k, G = step3d.scalar_slab_plan(mesh, (1, 2, *res), n_iters)
    band = 2 * 4 * (G * Y * X + 2 * G * Y + 2 * Y * X) if sliver else 2 * 2 * G * Y * X * 4
    return 2 * 2 * G * Y * X * 4 + n_iters // k * band, 2 + 2 * (n_iters // k)


@pytest.mark.parametrize("emit", [False, True], ids=["psi", "h2"])
@pytest.mark.parametrize("dtype", [torch.float32, BF], ids=["f32", "bf16"])
def test_psi_refresh_bytes_counted(scene, monkeypatch, dtype, emit):
    """Bytes and exchanges each rank makes in a solve of 30 sweeps in
    rounds of 3 on 2 slabs of 8 planes, the option on and off, as
    :func:`channel_bytes` counts them."""
    e = 2 if dtype == BF else 4
    for psi in (True, False):
        _, ring = solve(scene, 2, monkeypatch, n_iters=30, k=3, dtype=dtype, emit=emit, psi=psi)
        for r in range(2):
            want = channel_bytes(z_mesh(2, r), 30, emit, e, psi, k=3)
            assert (ring.sent[r], ring.count[r]) == want, (psi, r)


def test_psi_ghost_band_plain_is_the_stored_planes(scene):
    """A slab swept at tau 1: the bands its neighbours rebuild from its psi,
    innermost plane and edge columns equal its stored planes bit for bit, in
    float32 and bfloat16, both sides, at 2 and 5 planes."""
    for dtype in (torch.float32, BF):
        h, psi = poisson.poisson_sweeps_plain(scene["h"].to(dtype), scene["mf"], scene["rhs"],
                                              tau=1.0, n_iters=3)
        for G in (2, 5):
            for band, planes in (("lo", slice(16 - G, 16)), ("hi", slice(0, G))):
                outer = slice(16 - G, 15) if band == "lo" else slice(1, G)
                got = psi_halo.psi_ghost_band(psi_halo.pack(h, psi, G, band),
                                              scene["rhs"][:, :, outer].contiguous(), band=band,
                                              G=G, Y=RES[1], X=RES[2], dtype=dtype)
                assert got.dtype == dtype and torch.equal(got, h[:, :, planes]), (dtype, G, band)


def test_psi_ghost_band_checks_its_arguments(scene):
    h, psi = poisson.poisson_sweeps_plain(scene["h"], scene["mf"], scene["rhs"], tau=1.0,
                                          n_iters=1)
    packed = psi_halo.pack(h, psi, 3, "lo")
    assert packed.numel() == psi_halo.layout(3, *RES[1:], torch.float32)[1] == psi_bytes(
        3, *RES[1:], 4)
    rhs = scene["rhs"][:, :, :2]
    with pytest.raises(ValueError, match="band in"):
        psi_halo.psi_ghost_band(packed, rhs, band="up", G=3, Y=8, X=16, dtype=torch.float32)
    with pytest.raises(ValueError, match="bytes"):
        psi_halo.psi_ghost_band(packed[1:], rhs, band="lo", G=3, Y=8, X=16, dtype=torch.float32)
    nbytes, flops = psi_halo.cost(packed, rhs, G=3, Y=8, X=16, dtype=torch.float32)
    assert nbytes == packed.numel() + 4 * 2 * 128 + 19 * 3 * 128 * 4
    assert flops == 21 * 2 * 8 * 14


# ---------------------------------------------------------------------------
# the gates
# ---------------------------------------------------------------------------

def test_psi_refresh_gates(scene, monkeypatch):
    """The full-h exchange where the refresh does not hold: at tau 0.8, at G
    == Zl (k = 4 on 4-plane slabs, whose outermost band plane can be a z
    edge plane), with one band plane, and without ``psi_halo`` (what the
    step passes without the shell declaration or with
    ``poisson_psi_halo=False``)."""
    assert step3d.psi_refresh_ok(1.0, 3, 8) and not step3d.psi_refresh_ok(0.8, 3, 8)
    assert not step3d.psi_refresh_ok(1.0, 4, 4) and not step3d.psi_refresh_ok(1.0, 1, 8)
    for kw in (dict(tau=0.8), dict(psi=False)):
        _, on = solve(scene, 2, monkeypatch, n_iters=7, k=3, **kw)
        _, off = solve(scene, 2, monkeypatch, n_iters=7, k=3, psi=False)
        assert on.sent == off.sent, kw
    # 4 planes a slab, k = 4, psi out: every band is G == Zl
    _, on = solve(scene, 4, monkeypatch, n_iters=8, k=4)
    _, off = solve(scene, 4, monkeypatch, n_iters=8, k=4, psi=False)
    assert on.sent == off.sent


def test_step_passes_the_options_under_the_shell_only(monkeypatch):
    """``_solve_slab`` passes ``psi_halo`` and ``shell_sliver`` as the JAX
    step does (:466-471, :509): each option and the shell declaration."""
    from types import SimpleNamespace

    from lbm_ferrofluid_tpu_torch.models import SimulationParams, ferrofluid

    seen = {}
    monkeypatch.setattr(ferrofluid, "solve_H_int",
                        lambda *a, **kw: seen.setdefault("psi_halo", kw["psi_halo"]))
    monkeypatch.setattr(step3d, "scalar_poisson_sharded",
                        lambda *a, **kw: seen.setdefault("sliver", kw["shell_sliver"]))
    for shell in (False, True):
        for on in (False, True):
            p = SimulationParams(dim=3, mag_flags_shell=shell, poisson_psi_halo=on,
                                 scalar_sliver=on)
            seen.clear()
            for C in (19, 2):
                st = SimpleNamespace(h=torch.zeros(1, C, 1, 1, 1), cmask=None,
                                     magnetic_flags=None)
                ferrofluid._solve_slab(p, st, None, None, False)
            assert seen == {"psi_halo": shell and on, "sliver": shell and on}


# ---------------------------------------------------------------------------
# the scalar sliver
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def scalar_scene():
    """The scalar carry (s, s_prev) of the shell geometry at 16x8x16, its
    cmask and the source, from the seed (JAX
    tests/test_sharded_step.py:test_scalar_poisson_sharded_matches)."""
    rng = np.random.default_rng(1234)
    mf = np.full((1, 1, *RES), OBS, np.uint8)
    mf[..., 1:-1, :, 1:-1] = FLUID
    mask = (mf == FLUID).astype(np.float32)
    s2 = np.concatenate([rng.uniform(-1, 1, (1, 1, *RES)).astype(np.float32) * mask
                         for _ in range(2)], axis=1)
    rhs = rng.uniform(-0.01, 0.01, (1, 1, *RES)).astype(np.float32)
    return dict(s2=torch.from_numpy(s2), mf=torch.from_numpy(mf), rhs=torch.from_numpy(rhs))


def scalar_solve(sc, nz, monkeypatch, n_iters, sliver):
    cmask = make_cmask(sc["mf"])

    def rank(mesh):
        i = mesh.iz
        return step3d.scalar_poisson_sharded(cut(sc["s2"], nz, i), cut(cmask, nz, i),
                                             cut(sc["rhs"], nz, i), mesh, n_iters=n_iters,
                                             h_ext=H_EXT, shell_sliver=sliver)

    parts, ring = on_ranks(nz, rank, monkeypatch)
    return (gather(parts, 0), gather(parts, 1)), ring


def zero_signs(x):
    return x + 0.0  # -0.0 + 0.0 is +0.0


@pytest.mark.parametrize("nz,n_iters", [(2, 4), (4, 4), (2, 12), (4, 6)])
def test_sliver_bit_for_bit(scalar_scene, monkeypatch, nz, n_iters, tmp_path):
    """The sliver solve equals the full-band one and one device's bit for
    bit up to the sign of a zero; its bands take G planes of s, 2 columns
    of s_prev and two planes of s_prev (global z = 1, Z - 2, or zeros)."""
    (h2_v, s2_v), ring_v = scalar_solve(scalar_scene, nz, monkeypatch, n_iters, True)
    (h2_f, s2_f), ring_f = scalar_solve(scalar_scene, nz, monkeypatch, n_iters, False)
    sliver = {"s2": s2_v, "H2": h2_v}
    with worker.keep_mismatch(tmp_path, "sliver vs full band", sliver, {"s2": s2_f, "H2": h2_f}):
        assert torch.equal(zero_signs(s2_v), zero_signs(s2_f))
        assert torch.equal(zero_signs(h2_v), zero_signs(h2_f))
    s2_1, h2_1 = scalar_wavefront_plain(scalar_scene["s2"], make_cmask(scalar_scene["mf"]),
                                        scalar_scene["rhs"], n_iters=n_iters, h_ext=H_EXT)
    with worker.keep_mismatch(tmp_path, "sliver vs one device", sliver, {"s2": s2_1, "H2": h2_1}):
        assert torch.equal(zero_signs(s2_v), zero_signs(s2_1))
        assert torch.equal(zero_signs(h2_v), zero_signs(h2_1))
    for r in range(nz):
        assert (ring_v.sent[r], ring_v.count[r]) == scalar_bytes(z_mesh(nz, r), n_iters, True)
        assert (ring_f.sent[r], ring_f.count[r]) == scalar_bytes(z_mesh(nz, r), n_iters, False)
    assert sum(ring_v.sent.values()) < sum(ring_f.sent.values())


def test_sliver_planes_agree_on_both_sides():
    """The sender and the receiver of every band place the planes of global
    z 1 and Z - 2 alike: each where the band holds it, None elsewhere."""
    for nz, Zl, G in ((2, 8, 5), (4, 4, 3), (4, 4, 4), (8, 2, 2), (2, 3, 3)):
        Z = nz * Zl
        for r in range(nz):
            for shift in (1, -1):
                me = Mesh(("batch", "z"), (1, nz), r, None, "gloo")
                to = Mesh(("batch", "z"), (1, nz), (r + shift) % nz, None, "gloo")
                send = step3d._sliver_planes(me, Zl, G, shift, True)
                assert send == step3d._sliver_planes(to, Zl, G, shift, False)
                first = r * Zl + (Zl - G if shift > 0 else 0)
                for z, g in zip((1, Z - 2), send):
                    held = [j for j in range(G) if (first + j) % Z == z]
                    assert [g] == held if held else g is None


# ---------------------------------------------------------------------------
# against JAX
# ---------------------------------------------------------------------------

def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("emit", [False, True], ids=["psi", "h2"])
@pytest.mark.parametrize("dtype", [torch.float32, BF], ids=["f32", "bf16"])
def test_psi_refresh_matches_jax(scene, monkeypatch, dtype, emit):
    """7 sweeps (6 with H2: JAX's final round emits H2 at 2 sweeps or more)
    on 2 slabs against JAX's ``poisson_sweeps_sharded(psi_halo=True)`` at
    its own bars: each its own plan (JAX depth 2; the port k = 4, then a
    remainder round), both with the refresh after the first round."""
    n = 6 if emit else 7
    got, _ = solve(scene, 2, monkeypatch, n_iters=n, dtype=dtype, emit=emit)
    jdt = jnp.bfloat16 if dtype == BF else jnp.float32
    mesh = jmake_mesh(("z",), (2,), devices=jax.devices()[:2])
    want = jstep3d.poisson_sweeps_sharded(
        jnp.asarray(scene["h"].numpy()).astype(jdt), jnp.asarray(scene["mf"].numpy()),
        jnp.asarray(scene["rhs"].numpy()), mesh, tau=1.0, n_iters=n, halo_depth=2,
        interpret=True, psi_halo=True, emit_h2=H_EXT if emit else None)
    if emit:
        assert want[2]
    for name, a, b in (("h", got[0], want[0]), ("psi or H2", got[1], want[1])):
        a, b = a.float().numpy(), np.asarray(b, np.float64)
        if dtype == torch.float32:
            assert _rel(a, b) <= 3e-6, name
        else:
            # JAX's bf16 bars; the float32 output's values count as apart
            # beyond the float32 bar, not at its last ulp
            assert _rel(a, b) <= 2e-2, name
            tol = 1e-12 if name == "h" else 3e-6 * np.abs(b).max()
            assert (np.abs(a - b) > tol).mean() <= 1e-3, name


def test_sliver_matches_jax(scalar_scene, monkeypatch):
    """4 sweeps on 4 slabs (two rounds of 2, a band exchange between them)
    against JAX's ``scalar_poisson_sharded(shell_sliver=True)`` at its bars
    (s2 rtol 3e-6, atol 1e-6; H2 rtol 2e-5, atol 1e-6)."""
    (h2, s2), _ = scalar_solve(scalar_scene, 4, monkeypatch, 4, True)
    from lbm_ferrofluid_tpu.ops.scalar_poisson import make_cmask as jcmask

    mf = jnp.asarray(scalar_scene["mf"].numpy())
    mesh = jmake_mesh(("z",), (4,), devices=jax.devices()[:4])
    jh2, js2 = jstep3d.scalar_poisson_sharded(
        jnp.asarray(scalar_scene["s2"].numpy()), jcmask(mf),
        jnp.asarray(scalar_scene["rhs"].numpy()), mesh, n_iters=4, h_ext=H_EXT,
        interpret=True, shell_sliver=True)
    np.testing.assert_allclose(s2.numpy(), np.asarray(js2), rtol=3e-6, atol=1e-6)
    np.testing.assert_allclose(h2.numpy(), np.asarray(jh2), rtol=2e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# on gloo ranks: exact bytes, and the step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return worker.run_psi(tmp_path_factory.mktemp("psi"))


@pytest.mark.parametrize("case", sorted(worker.PSI_SOLVES))
def test_gloo_solve_bytes_and_exchanges(ranks, case):
    """``ring_halo.sent_bytes`` and ``ring_halo.exchanges`` of one solve on
    rank 0 of (batch, z) = (2, 2) equal the counted formula with the option
    on and off; on and off give the same bits on every rank (the sliver up
    to the sign of a zero)."""
    got = ranks[f"solve.{case}"]
    form, storage, n, emit = worker.PSI_SOLVES[case]
    mesh = Mesh(("batch", "z"), (2, 2), 0, torch.device("cpu"), "gloo")
    for tag, on in (("on", True), ("off", False)):
        if form == "scalar":
            want = scalar_bytes(mesh, n, on)
        else:
            want = channel_bytes(mesh, n, emit, 2 if storage == "bfloat16" else 4, on)
        assert (int(got[f"bytes_{tag}"]), int(got[f"exchanges_{tag}"])) == want, tag
    assert int(got["bytes_on"]) < int(got["bytes_off"])
    assert bool(got["equal"])


def test_gloo_priming_checks_the_shell_over_the_domain(ranks):
    """The shell declaration, on which both options rest, is checked over
    the whole domain when a state primes on slabs: a magnetic obstacle off
    the shell on a slab's edge plane, which the slab's own interior check
    missed (repaired here), refuses priming on every rank."""
    assert bool(ranks["check"]["shell_refused"])


@pytest.mark.parametrize("route", worker.PSI_ROUTES)
def test_gloo_steps_bit_for_bit(ranks, route, tmp_path):
    """The flagship at tau 1 without the scalar carry, B = 2 on (batch, z)
    = (2, 2): each element on 2 z ranks, the psi refresh on, bit for bit to
    ``poisson_psi_halo=False`` and to one device's steps of the element."""
    got, off = ranks[route], ranks[f"{route}_full"]
    with worker.keep_mismatch(tmp_path, f"{route} psi on vs off", got, off):
        for name in worker.PSI_FIELDS:
            np.testing.assert_array_equal(got[name], off[name], err_msg=name)
    for b in range(2):
        ref = worker.psi_reference(route, b)
        with worker.keep_mismatch(tmp_path, f"{route} element {b} vs one device",
                                  {n: got[n][b:b + 1] for n in worker.PSI_FIELDS}, ref):
            for name in worker.PSI_FIELDS:
                np.testing.assert_array_equal(got[name][b:b + 1], ref[name],
                                              err_msg=f"{name} {b}")
    assert float(got["stats.bytes"]) < float(off["stats.bytes"])


@pytest.mark.parametrize("route", worker.PSI_ROUTES)
def test_gloo_steps_match_jax(ranks, route):
    """The same steps against JAX's single-device steps of each element
    (``use_pallas=False``) at tests/test_torch_parallel_channel.py's bars."""
    got = ranks[route]
    for b in range(2):
        kw, fields = worker.psi_config(b)
        p = jmodels.SimulationParams(**kw).replace(use_pallas=False)
        s = jmodels.init_ferrofluid_state(p, *fields)
        for _ in range(worker.PSI_STEPS):
            s = jmodels.ferrofluid_step(p, s)
        for name in worker.PSI_FIELDS:
            np.testing.assert_allclose(got[name][b:b + 1], np.asarray(getattr(s, name)),
                                       rtol=2e-5, atol=1e-6, err_msg=f"{name} {b}")
