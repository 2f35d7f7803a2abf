"""B1's pass plan and its schedule, on the CPU.

The CUDA kernel (``csrc/scalar_poisson.cu:lbm_scalar_pass``) runs the
sweeps as passes of k sweeps, each a z-wavefront over (32 - 2k) x ty tiles
with a k-cell halo and z chunks of lz planes, as ``plan`` chooses.  It
cannot run here, so ``emulate`` replays its schedule in PyTorch: the
extended tiles read with periodic wrap, the extended z window of each
chunk, one 3-slot ring per stage, stage j's s_prev from stage j - 2's ring
(the input s_prev for stage 1), stage k's tile written out with stage
k - 1's plane as s_prev.  Cells a stage does not own are NaN, so any read
of them would show.  The per-cell arithmetic is the plain version's, so
the replay must equal ``scalar_sweeps_plain`` bit for bit: a difference
is a halo, wrap, ring or chunk error of the schedule.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lbm_ferrofluid_tpu_torch.ops.kernels import scalar_poisson as sp  # noqa: E402
from lbm_ferrofluid_tpu_torch.ops.scalar_poisson import make_cmask  # noqa: E402

#: grids that chip_smoke and the main paths hand to B1, and a Z = 3 grid
GRIDS = [(34, 66, 130), (130, 66, 130), (256, 256, 256), (3, 66, 130), (50, 50, 193)]
#: SMs of an H100 SXM
SMS = 132


@pytest.mark.parametrize("grid", GRIDS)
def test_plan_divides_thirty_sweeps_and_fits_shared_memory(grid):
    pl = sp.plan(*grid, 30, SMS)
    assert 30 % pl.k == 0 and pl.passes == (pl.k,) * (30 // pl.k)
    assert pl.k >= 2
    assert sp.smem_bytes(pl.k, pl.ty) <= sp.SMEM_BLOCK_MAX == 232_448
    assert sp.launches_per_call(30, (1, 2, *grid)) == 30 // pl.k + 1


@pytest.mark.parametrize("n_iters", [7, 13, 29])
@pytest.mark.parametrize("grid", GRIDS)
def test_plan_runs_a_remainder_pass(grid, n_iters):
    pl = sp.plan(*grid, n_iters, SMS)
    assert sum(pl.passes) == n_iters
    assert all(k == pl.k for k in pl.passes[:-1]) and 1 <= pl.passes[-1] <= pl.k
    if n_iters % pl.k:
        assert pl.passes[-1] == n_iters % pl.k
    for k in set(pl.passes):
        assert sp.smem_bytes(k, pl.ty) <= sp.SMEM_BLOCK_MAX
    assert sp.launches_per_call(n_iters, grid) == len(pl.passes) + 1


@pytest.mark.parametrize("grid", [(34, 66, 130), (130, 66, 130)])
def test_seven_sweeps_take_a_remainder_pass_where_chip_smoke_checks_them(grid):
    pl = sp.plan(*grid, 7, SMS)
    assert 7 % pl.k != 0 and pl.passes == (pl.k,) * (7 // pl.k) + (7 % pl.k,)


@pytest.mark.parametrize("grid", GRIDS)
def test_plan_stays_inside_the_kernel_limits(grid):
    """What lbm_scalar_pass accepts: 1 <= k <= 6, 4 <= ty <= 48 - 2k, and
    z chunks that each hold a plane."""
    Z, Y, X = grid
    pl = sp.plan(Z, Y, X, 30, SMS)
    assert 1 <= pl.k <= sp.MAX_K
    assert sp.ROWS <= pl.ty and pl.ty + 2 * pl.k <= sp.MAX_EXT_HEIGHT
    assert 1 <= pl.lz <= Z and -(-Z // pl.lz) * pl.lz - pl.lz < Z


def test_plan_raises_where_nothing_fits(monkeypatch):
    sp.plan.cache_clear()
    monkeypatch.setattr(sp, "SMEM_BLOCK_MAX", 4_096)
    with pytest.raises(ValueError, match="shared memory"):
        sp.plan(256, 256, 256, 30, SMS)
    with pytest.raises(ValueError):
        sp.plan(2, 66, 130, 30, SMS)
    with pytest.raises(ValueError):
        sp.plan(34, 66, 130, 0, SMS)
    with pytest.raises(ValueError):
        sp.launches_per_call(30, (2, 66, 130))


@pytest.mark.parametrize("grid,lz", [((256, 256, 256), 52), ((130, 66, 130), 8)])
def test_plan_takes_the_chunks_timed_fastest_on_an_h100(grid, lz):
    """The plans timed fastest at both grids (chip_smoke.py --scalar-plans):
    k = 3 on 26 x 28 tiles, 500 blocks of 52 planes at 256^3 and 255 of 8
    at 130x66x130, within two waves and one wave of 2 x 132."""
    pl = sp.plan(*grid, 30, SMS)
    assert (pl.k, pl.ty, pl.lz) == (3, 28, lz)


def test_plan_fills_the_card_it_is_given():
    """Fewer SMs take longer chunks: the z chunk follows the SM count."""
    lzs = [sp.plan(130, 66, 130, 30, sms).lz for sms in (132, 66, 16)]
    assert lzs == sorted(lzs) and lzs[0] < lzs[-1]


def _stage(a0, am, ap, prev, cmw, rhw, j, EY, EX):
    """One stage on its region [j, EY - j) x [j, EX - j) of the extended
    tile: the plain version's taps, in its order."""
    R, C = slice(j, EY - j), slice(j, EX - j)
    Rm, Rp, Cm, Cp = slice(j - 1, EY - j - 1), slice(j + 1, EY - j + 1), \
        slice(j - 1, EX - j - 1), slice(j + 1, EX - j + 1)
    A = a0[R, Cm] + a0[R, Cp] + a0[Rm, C] + a0[Rp, C] + am[R, C] + ap[R, C]
    D = (a0[Rm, Cm] + a0[Rm, Cp] + a0[Rp, Cm] + a0[Rp, Cp] + am[R, Cm] + am[R, Cp]
         + ap[R, Cm] + ap[R, Cp] + am[Rm, C] + am[Rp, C] + ap[Rm, C] + ap[Rp, C])
    psi = A * sp.W1 + D * sp.W2 + torch.clamp(cmw, min=0.0) * prev
    return psi, (psi + rhw) * (cmw >= 0.0).to(psi.dtype)


def emulate_pass(read, Z, Y, X, k, ty, lz, write):
    """One pass of ``k`` sweeps on a window of Z planes of [Y, X] as
    lbm_scalar_pass schedules it: ``read(name, z)`` gives plane z (in [0,
    Z)) of field ``name`` ("s", "sp", "cmask", "rhs") as the kernel reads
    it; stage k's tile of plane w goes to ``write(w, y0, x0, (s',
    s_prev', psi))``, each [ny, nx] of the tile inside the grid."""
    tx, EX, EY = sp.EXT_WIDTH - 2 * k, sp.EXT_WIDTH, ty + 2 * k
    nan = float("nan")
    for y0 in range(0, Y, ty):
        rows = (y0 - k + torch.arange(EY)) % Y
        for x0 in range(0, X, tx):
            cols = (x0 - k + torch.arange(EX)) % X

            def ext(name, w):
                return read(name, w % Z)[rows][:, cols]

            for z0 in range(0, Z, lz):
                z1 = min(z0 + lz, Z)
                ring = {}
                for t in range(z0 - k, z1 + k):
                    ring[0, t % 3] = ext("s", t)
                    for j in range(1, k + 1):
                        w = t - j
                        if not z0 - k + j <= w < z1 + k - j:
                            continue
                        R, C = slice(j, EY - j), slice(j, EX - j)
                        prev = ext("sp", w)[R, C] if j == 1 else ring[j - 2, w % 3][R, C]
                        psi, new = _stage(ring[j - 1, w % 3], ring[j - 1, (w - 1) % 3],
                                          ring[j - 1, (w + 1) % 3], prev,
                                          ext("cmask", w)[R, C], ext("rhs", w)[R, C], j, EY, EX)
                        if j < k:
                            plane = torch.full((EY, EX), nan, dtype=psi.dtype)
                            plane[R, C] = new
                            ring[j, w % 3] = plane
                            continue
                        ny, nx = min(ty, Y - y0), min(tx, X - x0)
                        last = ring[k - 1, w % 3][R, C]
                        write(w % Z, y0, x0, tuple(v[:ny, :nx] for v in (new, last, psi)))


def emulate(s2, cmask, rhs, n_iters, pl):
    """``n_iters`` sweeps as the plan's passes: (s2', psi)."""
    fields = {"s": s2[0, 0], "sp": s2[0, 1], "cmask": cmask[0, 0], "rhs": rhs[0, 0]}
    Z, Y, X = fields["cmask"].shape
    outs = None
    for k in pl.passes:
        outs = [torch.full_like(fields["s"], float("nan")) for _ in range(3)]

        def write(w, y0, x0, tiles, outs=outs):
            for out, v in zip(outs, tiles):
                out[w, y0:y0 + v.shape[0], x0:x0 + v.shape[1]] = v

        emulate_pass(lambda name, z: fields[name][z], Z, Y, X, k, pl.ty, pl.lz, write)
        fields.update(s=outs[0], sp=outs[1])
    return torch.stack(outs[:2])[None], outs[2][None, None]


def banded(lo, mid, hi, G, Zl):
    """Plane z of the window [0, Zl + 2G) of a [Z', Y, X] field held in
    three parts, as ``csrc/scalar_poisson.cu:lbm_plane`` reads it:
    lo below G, mid below G + Zl (at z - G), hi above (at z - G - Zl)."""
    return lambda z: lo[z] if z < G else (mid[z - G] if z < G + Zl else hi[z - G - Zl])


def contiguous(x, G, Zl):
    """The parts of a window held in one array (the pointers
    ``scalar_poisson._parts`` gives): lo from plane 0, mid from G, hi
    from G + Zl."""
    return banded(x, x[G:], x[G + Zl:], G, Zl)


def emulate_round(s2, ghosts, cmask, rhs, n_iters, pl, *, aux=None, emit_bands=False,
                  psi_planes=None):
    """A slab round as ``scalar_poisson._passes`` launches it: the window
    of the slab's Zl planes and the G ghost planes a side read in place
    (``ghosts`` the (s, s_prev) bands; cmask and rhs extended, or the
    slab's with ``aux`` their bands), the passes before the last writing
    the whole window into a fresh buffer, the last writing what lives on
    as the kernel's SPLIT instance writes it: the slab's planes, with ``emit_bands`` planes
    [G, 2G) and [Zl, Zl + G) into two [2, G, Y, X] bands, and psi of
    ``psi_planes`` = (first, count).  Unwritten cells stay NaN.  Returns
    (s2', bands or None, psi or None)."""
    G, Zl = ghosts[0].shape[2], s2.shape[2]
    Z, (Y, X) = Zl + 2 * G, s2.shape[3:]
    nan = float("nan")
    read = {name: banded(ghosts[0][0, c], s2[0, c], ghosts[1][0, c], G, Zl)
            for c, name in enumerate(("s", "sp"))}
    for c, (name, x) in enumerate((("cmask", cmask), ("rhs", rhs))):
        read[name] = (contiguous(x[0, 0], G, Zl) if aux is None
                      else banded(aux[0][0, c], x[0, 0], aux[1][0, c], G, Zl))
    for i, k in enumerate(pl.passes):
        if i < len(pl.passes) - 1:
            buf = torch.full((2, Z, Y, X), nan, dtype=s2.dtype)

            def write(w, y0, x0, tiles, buf=buf):
                for c in (0, 1):
                    buf[c, w, y0:y0 + tiles[c].shape[0], x0:x0 + tiles[c].shape[1]] = tiles[c]

            emulate_pass(lambda name, z: read[name](z), Z, Y, X, k, pl.ty, pl.lz, write)
            read.update(s=contiguous(buf[0], G, Zl), sp=contiguous(buf[1], G, Zl))
            continue
        out = torch.full((2, Zl, Y, X), nan, dtype=s2.dtype)
        bands = [torch.full((2, G, Y, X), nan, dtype=s2.dtype) for _ in range(2)]
        psi = torch.full((psi_planes[1], Y, X), nan, dtype=s2.dtype) if psi_planes else None

        def write(w, y0, x0, tiles):
            ys, xs = slice(y0, y0 + tiles[0].shape[0]), slice(x0, x0 + tiles[0].shape[1])
            for dst, first, count in ((out, G, Zl), *(((bands[0], G, G), (bands[1], Zl, G))
                                                     if emit_bands else ())):
                if first <= w < first + count:
                    for c in (0, 1):
                        dst[c, w - first, ys, xs] = tiles[c]
            if psi is not None and psi_planes[0] <= w < sum(psi_planes):
                psi[w - psi_planes[0], ys, xs] = tiles[2]

        emulate_pass(lambda name, z: read[name](z), Z, Y, X, k, pl.ty, pl.lz, write)
        return out[None], tuple(b[None] for b in bands) if emit_bands else None, (
            None if psi is None else psi[None, None])


def _inputs(res, seed):
    """A magnetic-shell geometry (obstacle planes at z = 0 and Z - 1) with
    an interior obstacle block, s and s_prev fluid-masked, a small rhs."""
    Z, Y, X = res
    rng = np.random.default_rng(seed)
    flags = np.full((1, 1, *res), 1, np.uint8)
    flags[..., 0, :, :] = 2
    flags[..., -1, :, :] = 2
    flags[..., Z // 2, Y // 2, 1:3] = 2
    cmask = make_cmask(torch.from_numpy(flags))
    fluid = (cmask >= 0).to(torch.float32)
    s2 = torch.from_numpy(rng.standard_normal((1, 2, *res)).astype(np.float32)) * fluid
    rhs = torch.from_numpy(1e-3 * rng.standard_normal((1, 1, *res)).astype(np.float32)) * fluid
    return s2, cmask, rhs


@pytest.mark.parametrize("n_iters", [30, 7])
@pytest.mark.parametrize("res,tile", [
    ((7, 30, 29), None),           # the plan's own choice: 2 x 2 tiles, 1-plane chunks
    ((5, 9, 37), dict(ty=4, lz=2)),  # tiles and chunks that divide nothing
    ((4, 11, 61), dict(ty=8, lz=3)),
])
def test_schedule_equals_plain_sweeps_bit_for_bit(res, tile, n_iters):
    s2, cmask, rhs = _inputs(res, seed=sum(res) + n_iters)
    pl = sp.plan(*res, n_iters, SMS)
    if tile:
        pl = dataclasses.replace(pl, **tile)
    got_s2, got_psi = emulate(s2, cmask, rhs, n_iters, pl)
    want_s2, want_psi = sp.scalar_sweeps_plain(s2, cmask, rhs, n_iters)
    assert torch.equal(got_s2, want_s2)
    assert torch.equal(got_psi, want_psi)


def test_schedule_at_the_deepest_pass_wraps_a_small_grid():
    """k = 6 on a 3-plane grid: the extended window wraps z twice over."""
    res = (3, 6, 9)
    s2, cmask, rhs = _inputs(res, seed=3)
    pl = sp.ScalarPlan(k=6, ty=4, lz=2, passes=(6, 6, 1))
    got_s2, got_psi = emulate(s2, cmask, rhs, 13, pl)
    want_s2, want_psi = sp.scalar_sweeps_plain(s2, cmask, rhs, 13)
    assert torch.equal(got_s2, want_s2)
    assert torch.equal(got_psi, want_psi)


#: the slab rounds the replay holds to the plain slab form, (k sweeps, G
#: ghost planes a side): one pass a round (k <= 3) and several (k = 5:
#: passes 3 and 2; k = 7: 3, 3 and 1), at G = k + 1 and deeper
ROUNDS = [(2, 3), (3, 4), (1, 5), (5, 6), (5, 8), (7, 8)]
#: the domain the slabs are cut from (2 slabs of 8 planes): 2 x-tiles at
#: k <= 3, 3 y-tiles of the 4-row tiles below
SLAB_RES = (16, 9, 29)


def _cut(x, i, lo=0, hi=0, nz=2):
    """Planes [i Zl - lo, (i + 1) Zl + hi) of ``x`` (z wrapped)."""
    Zl = x.shape[2] // nz
    return x[:, :, [z % x.shape[2] for z in range(i * Zl - lo, (i + 1) * Zl + hi)]].contiguous()


def _slab(i, G, seed=5):
    """Slab i of 2 of the shell geometry: (s2, (s, s_prev) bands, cmask and
    rhs extended, cmask and rhs of the slab, their (cmask, rhs) bands)."""
    s2, cmask, rhs = _inputs(SLAB_RES, seed)
    c_ext, r_ext = _cut(cmask, i, G, G), _cut(rhs, i, G, G)
    aux = tuple(torch.cat([c_ext[:, :, z], r_ext[:, :, z]], dim=1).contiguous()
                for z in (slice(0, G), slice(-G, None)))
    bands = (_cut(s2, i, G)[:, :, :G].contiguous(), _cut(s2, i, 0, G)[:, :, -G:].contiguous())
    return _cut(s2, i), bands, c_ext, r_ext, _cut(cmask, i), _cut(rhs, i), aux


@pytest.mark.parametrize("form", ["extended", "banded"])
@pytest.mark.parametrize("tile", [None, dict(ty=4, lz=3)], ids=["plan", "odd_tiles"])
@pytest.mark.parametrize("k,G", ROUNDS, ids=[f"k{k}-G{G}" for k, G in ROUNDS])
def test_slab_round_replay_equals_plain_bit_for_bit(k, G, tile, form):
    """The slab form's launches replayed through the kernel's banded plane
    map (``lbm_plane``) and its last pass's outputs (the SPLIT instance): the
    slab's planes and its two bands (``emit_bands``), and psi of the
    planes [G - 1, G + Zl + 1) that H2 reads, bit for bit to the plain
    version's extended copy.  cmask and rhs extended (the TPU kernel's
    contract) or read as the slab's planes with their bands."""
    s2, bands, c_ext, r_ext, c, r, aux = _slab(1, G, seed=10 * k + G)
    Zl, (Y, X) = s2.shape[2], s2.shape[3:]
    pl = sp.plan(Zl + 2 * G, Y, X, k, SMS)
    if tile:
        pl = dataclasses.replace(pl, **tile)
    assert sum(pl.passes) == k
    cm, rh, ax = (c_ext, r_ext, None) if form == "extended" else (c, r, aux)
    got_s2, got_bands, got_psi = emulate_round(s2, bands, cm, rh, k, pl, aux=ax,
                                               emit_bands=True, psi_planes=(G - 1, Zl + 2))
    want_s2, want_bands = sp.scalar_wavefront_plain(s2, c_ext, r_ext, n_iters=k, emit=None,
                                                    ghosts=bands, emit_bands=True)
    assert torch.equal(got_s2, want_s2)
    assert torch.equal(got_bands[0], want_bands[0]) and torch.equal(got_bands[1], want_bands[1])
    _, psi = sp.scalar_sweeps_plain(torch.cat([bands[0], s2, bands[1]], dim=2), c_ext, r_ext, k)
    assert torch.equal(got_psi, psi[:, :, G - 1:G + Zl + 1])


@pytest.mark.parametrize("i", [0, 1], ids=["edge", "interior"])
@pytest.mark.parametrize("k,G", [(2, 3), (5, 6), (3, 7)])
def test_plain_slab_form_banded_equals_extended(k, G, i):
    """The plain version with cmask and rhs as the slab's planes and their
    bands (``aux_ghosts``) equals it with them extended, bit for bit: a
    round with ``emit_bands`` and a final round with H2 under the slab's
    clamp."""
    s2, bands, c_ext, r_ext, c, r, aux = _slab(i, G)
    Zl = s2.shape[2]
    got = sp.scalar_wavefront_plain(s2, c, r, n_iters=k, emit=None, ghosts=bands,
                                    emit_bands=True, aux_ghosts=aux)
    want = sp.scalar_wavefront_plain(s2, c_ext, r_ext, n_iters=k, emit=None, ghosts=bands,
                                     emit_bands=True)
    assert torch.equal(got[0], want[0])
    assert all(torch.equal(a, b) for a, b in zip(got[1], want[1], strict=True))
    clamp = (G + 1 if i == 0 else 1, Zl + 2 * G - 2)
    kw = dict(n_iters=k, h_ext=(0.0, 85.0, 0.0), ghosts=got[1], slab_clamp=clamp)
    got = sp.scalar_wavefront_plain(got[0], c, r, aux_ghosts=aux, **kw)
    want = sp.scalar_wavefront_plain(want[0], c_ext, r_ext, **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("i", [0, 1], ids=["edge", "interior"])
def test_slab_h2_reads_psi_only_where_the_last_pass_writes_it(i):
    """H2 of the slab's planes reads psi only on the window's planes [G - 1,
    G + Zl + 1), the planes the round's last pass writes for it: psi NaN
    elsewhere leaves the slab's H2 bit for bit as it was."""
    k, G = 3, 4
    s2, bands, c_ext, r_ext, *_ = _slab(i, G)
    Zl = s2.shape[2]
    _, psi = sp.scalar_sweeps_plain(torch.cat([bands[0], s2, bands[1]], dim=2), c_ext, r_ext, k)
    part = torch.full_like(psi, float("nan"))
    part[:, :, G - 1:G + Zl + 1] = psi[:, :, G - 1:G + Zl + 1]
    clamp = (G + 1 if i == 0 else 1, Zl + 2 * G - 2)
    want = sp.h2_slab_plain(psi, c_ext, 1.0, (0.0, 85.0, 0.0), G, Zl, clamp)
    got = sp.h2_slab_plain(part, c_ext, 1.0, (0.0, 85.0, 0.0), G, Zl, clamp)
    assert torch.isfinite(want).all() and torch.equal(got, want)


def test_slab_form_checks_the_bands_of_cmask_and_rhs():
    """cmask and rhs of the slab's planes need their bands; extended ones
    take none."""
    s2, bands, c_ext, r_ext, c, r, aux = _slab(1, 3)
    with pytest.raises(ValueError, match="aux_ghosts"):
        sp.scalar_wavefront_plain(s2, c, r, n_iters=2, emit=None, ghosts=bands, emit_bands=True)
    with pytest.raises(ValueError, match="aux_ghosts"):
        sp.scalar_wavefront_plain(s2, c_ext, r_ext, n_iters=2, emit=None, ghosts=bands,
                                  emit_bands=True, aux_ghosts=aux)
