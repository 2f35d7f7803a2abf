"""B11b's pass plan and its schedule, on the CPU.

The CUDA kernel (``csrc/poisson.cu:lbm_poisson_pass``) runs the channel-form
sweeps as passes of k sweeps, each a z-wavefront over tiles ``tile_width(k)``
(a multiple of 8) x ty, with ``halo_left(k)`` >= k columns of halo on the
left, at least k on the right and k - 1 rows, and z chunks of lz planes, as
``plan`` chooses.  It cannot run here, so ``emulate`` replays its schedule
in PyTorch: each tick the input plane takes, through the wrapped column and
row tables of the extended tile (columns 0..31, rows -1..EY), every
channel's source plane of the plane stage 1 computes; stage 1 pulls from
it, each later stage from the ring of the stage before it, whose slots
keep the 9 channels with e_z = 0 for 2 planes, the 5 with e_z = +1 for 3
and the 5 with e_z = -1 for 1; flags and rhs sit in a (k + 1)-plane ring; the
last stage writes the tile.  Ring cells no stage has written are NaN, and
a slot still holds the plane it held before, so a read of the wrong slot,
row, column or plane shows.  The per-cell arithmetic is
``poisson.sweep_cell``, the plain version's, so the replay must equal
``poisson_sweeps_plain`` bit for bit: a difference is a halo, wrap, ring or
seam error of the schedule.
"""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lbm_ferrofluid_tpu_torch.lattice import D3Q19  # noqa: E402
from lbm_ferrofluid_tpu_torch.ops.kernels import poisson as pp  # noqa: E402

#: grids the main paths and chip_smoke hand to B11b, and a 4-plane grid
GRIDS = [(256, 256, 256), (130, 66, 130), (34, 66, 130), (50, 50, 193), (4, 8, 16)]
#: SMs of an H100 SXM
SMS = 132
OBS, FLUID = 2, 1


@pytest.mark.parametrize("grid", GRIDS)
def test_plan_divides_thirty_sweeps_and_fits_shared_memory(grid):
    pl = pp.plan(*grid, 30, SMS)
    assert 30 % pl.k == 0 and pl.passes == (pl.k,) * (30 // pl.k)
    assert pl.k >= 2
    assert pp.smem_bytes(pl.k, pl.ty) <= pp.SMEM_BLOCK_MAX == 232_448
    assert pp.launches_per_call(30, (1, 19, *grid)) == 30 // pl.k < 30


@pytest.mark.parametrize("grid", GRIDS)
def test_plan_tiles_the_grid_within_the_kernel_limits(grid):
    """Every cell falls in one tile and one chunk, and the tile is what
    lbm_poisson_pass accepts: 1 <= k <= 4, ty + 2k - 2 one of the extended
    heights it is built for, a warp per input row."""
    Z, Y, X = grid
    pl = pp.plan(Z, Y, X, 30, SMS)
    tx = pp.tile_width(pl.k)
    assert 1 <= pl.k <= pp.MAX_K and pl.ty + 2 * pl.k - 2 in pp.EXT_HEIGHTS
    assert tx % 8 == 0 and 0 < tx <= pp.EXT_WIDTH - 2 * pl.k and pl.ty >= 1
    assert pl.k <= pp.halo_left(pl.k) and pp.halo_left(pl.k) + tx + pl.k <= pp.EXT_WIDTH
    assert pp.threads(pl.k, pl.ty) == 32 * (pl.ty + 2 * pl.k) <= 1024
    for n, t in ((X, tx), (Y, pl.ty), (Z, pl.lz)):
        blocks = -(-n // t)
        assert (blocks - 1) * t < n <= blocks * t


@pytest.mark.parametrize("n_iters", [7, 29])
@pytest.mark.parametrize("grid", GRIDS)
def test_plan_runs_a_remainder_pass(grid, n_iters):
    pl = pp.plan(*grid, n_iters, SMS)
    assert sum(pl.passes) == n_iters
    assert all(k == pl.k for k in pl.passes[:-1]) and 1 <= pl.passes[-1] < pl.k
    assert pl.passes[-1] == n_iters % pl.k
    for k in set(pl.passes):
        pp.check_pass(k, pl.ty)
        assert pp.smem_bytes(k, pl.ty) <= pp.SMEM_BLOCK_MAX
    assert pp.launches_per_call(n_iters, grid) == len(pl.passes) == -(-n_iters // pl.k)


@pytest.mark.parametrize("n_iters,want", [(1, 1), (2, 1), (3, 1), (7, 3), (29, 10), (30, 10)])
def test_launches_per_call(n_iters, want):
    assert pp.launches_per_call(n_iters, (1, 19, 34, 66, 130)) == want


def test_plan_raises_where_nothing_fits(monkeypatch):
    pp.plan.cache_clear()
    monkeypatch.setattr(pp, "SMEM_BLOCK_MAX", 4_096)
    with pytest.raises(ValueError, match="shared memory"):
        pp.plan(256, 256, 256, 30, SMS)
    with pytest.raises(ValueError, match="shared memory"):
        pp.check_pass(pp.K, pp.TY)
    # a pass deeper than the kernel's limit, and extended heights (19 rows,
    # 16 rows) it is not built for
    for k, ty in ((pp.MAX_K + 1, 3), (3, 15), (1, 16)):
        with pytest.raises(ValueError, match="limits"):
            pp.check_pass(k, ty)
    with pytest.raises(ValueError):
        pp.plan(0, 66, 130, 30, SMS)
    with pytest.raises(ValueError):
        pp.plan(34, 66, 130, 0, SMS)
    with pytest.raises(ValueError):
        pp.launches_per_call(0, (34, 66, 130))


def test_kernel_limits_are_the_cuda_sources():
    """``MAX_K`` and ``EXT_HEIGHTS`` are csrc/poisson.cu's PP_MAX_K and
    PP_EXT_HEIGHTS, which instantiate the pass kernel; every plan's passes
    and every plan ``chip_smoke.py --poisson-plans`` times (k = 1..4 at
    its tile heights, with the remainder of 30 sweeps) are among them."""
    src = (Path(pp.__file__).parents[2] / "csrc" / "poisson.cu").read_text()
    assert int(re.search(r"#define PP_MAX_K (\d+)", src)[1]) == pp.MAX_K
    line = re.search(r"#define PP_EXT_HEIGHTS\(M\) (.*)", src)[1]
    assert tuple(int(e) for e in re.findall(r"M\((\d+)\)", line)) == pp.EXT_HEIGHTS
    assert int(re.search(r"#define PP_SMEM_MAX (\d+)", src)[1]) == pp.SMEM_BLOCK_MAX
    swept = {1: (8, 12), 2: (8, 12, 16), 3: (5, 7, 9, 11), 4: (3, 5)}
    for k, tys in swept.items():
        for ty in tys:
            for kk in set(pp.passes(30, k)):
                pp.check_pass(kk, ty)
    for n in (1, 2, 7, 29, 30):
        for kk in set(pp.passes(n)):
            pp.check_pass(kk, pp.TY)


def test_smem_bytes_counts_the_rings_by_channel_lifetime():
    """38 floats a cell and ring (9 x 2 + 5 x 3 + 5 x 1), where three
    whole planes of 19 channels would take 57."""
    assert pp.RING_FLOATS == 9 * 2 + 5 * 3 + 5 * 1
    one, two = pp.smem_bytes(2, 12), pp.smem_bytes(3, 10)
    # k = 3 on 10 rows has the same extended height (14) as k = 2 on 12,
    # plus one ring (38 channel planes of 16 rows) and one rhs and one flags
    # plane of 14 rows
    assert two - one == 32 * (16 * 38 * 4 + 14 * (4 + 1))


def test_plan_fills_the_card_it_is_given():
    """Fewer SMs take longer chunks than the whole card (waves round the
    rest): the z chunk follows the SM count."""
    lzs = [pp.plan(130, 66, 130, 30, sms).lz for sms in (132, 66, 16)]
    assert lzs[0] < min(lzs[1:])


# ---------------------------------------------------------------- replay
def emulate_pass(h, is_obs, rhs, k, ty, lz, tau):
    """One pass of ``k`` sweeps on [19, Z, Y, X] h as lbm_poisson_pass
    schedules it: returns (h', psi of the last sweep)."""
    _, Z, Y, X = h.shape
    ex, ey, ez = (D3Q19.e[:, a] for a in range(3))
    tx, hx, EW, EY = pp.tile_width(k), pp.halo_left(k), pp.EXT_WIDTH, ty + 2 * (k - 1)
    nan = float("nan")
    out = torch.full_like(h, nan)
    psi_out = torch.full_like(h[:1], nan)
    q_idx = torch.arange(19)[:, None, None]
    ey_t, ex_t = torch.as_tensor(ey)[:, None], torch.as_tensor(ex)[:, None]

    def pull(src, rows):
        """s[q, i, c] = src[q, rows[i] - e_y(q), c - e_x(q)]; columns outside
        the extended tile (the edge lanes' reads) are NaN."""
        padded = torch.nn.functional.pad(src, (1, 1), value=nan)
        r = (rows[None, :] - ey_t)[:, :, None]
        c = (torch.arange(EW)[None, :] - ex_t + 1)[:, None, :]
        return padded[q_idx, r, c]
    for y0 in range(0, Y, ty):
        rowy = (y0 - k + torch.arange(EY + 2)) % Y  # rows -1..EY
        for x0 in range(0, X, tx):
            colx = (x0 - hx + torch.arange(EW)) % X  # columns 0..31
            for z0 in range(0, Z, lz):
                z1 = min(z0 + lz, Z)
                zb, n_ticks = z0 - k + 1, z1 - z0 + 2 * k - 2
                # stage rings: groups (e_z = 0: 2 slots, +1: 3, -1: 1)
                rings = {(j, g, s): torch.full((n, EY, EW), nan, dtype=h.dtype)
                         for j in range(1, k)
                         for g, slots, n in ((0, 2, 9), (1, 3, 5), (-1, 1, 5))
                         for s in range(slots)}
                fl_ring, rh_ring = {}, {}
                for r in range(n_ticks):
                    # the input plane: channel q of plane r - e_z(q), rows -1..EY
                    zsrc = torch.as_tensor((zb + r - ez) % Z)[:, None, None]
                    inp = h[q_idx, zsrc, rowy[None, :, None], colx[None, None, :]]
                    zr = (zb + r) % Z
                    fl_ring[r % (k + 1)] = is_obs[zr][rowy[1:EY + 1]][:, colx]
                    rh_ring[r % (k + 1)] = rhs[zr][rowy[1:EY + 1]][:, colx]
                    for j in range(1, k + 1):
                        p = r - j + 1
                        if not j - 1 <= p < n_ticks - j + 1:
                            continue
                        zw = (zb + p) % Z
                        e = torch.arange(j - 1, EY - j + 1)
                        if j == 1:
                            s = pull(inp, e + 1)
                        else:
                            src = torch.cat([rings[j - 1, 0, p % 2], rings[j - 1, 1, (p - 1) % 3],
                                             rings[j - 1, -1, 0]])
                            s = pull(src, e)
                        new, psi = pp.sweep_cell(s[None], fl_ring[p % (k + 1)][e][None, None],
                                                 rh_ring[p % (k + 1)][e][None, None], tau=tau)
                        new, psi = new[0], psi[0]
                        if j < k:
                            for g, n_slot, first in ((0, p % 2, 0), (1, p % 3, 9), (-1, 0, 14)):
                                n = 9 if g == 0 else 5
                                rings[j, g, n_slot][:, e] = new[first:first + n]
                            continue
                        ny, nx = min(ty, Y - y0), min(tx, X - x0)
                        tile = (slice(None), slice(0, ny), slice(hx, hx + nx))
                        out[:, zw, y0:y0 + ny, x0:x0 + nx] = new[tile]
                        psi_out[:, zw, y0:y0 + ny, x0:x0 + nx] = psi[tile]
    return out, psi_out


def emulate(h, flags, rhs, n_iters, pl, tau):
    """``n_iters`` sweeps as the plan's passes: (h', psi)."""
    is_obs = flags[0, 0] == OBS
    hh, psi = h[0], None
    for k in pl.passes:
        hh, psi = emulate_pass(hh, is_obs, rhs[0, 0], k, pl.ty, pl.lz, tau)
    return hh[None], psi[None]


def _inputs(res, seed, pl):
    """The Rosensweig magnetic shell (z planes, x-edge columns), a block
    of magnetic obstacles inside, and one that straddles the plan's first
    tile edge in x and y and its first z seam; h and rhs from the seed."""
    Z, Y, X = res
    rng = np.random.default_rng(seed)
    mf = np.full((1, 1, *res), OBS, np.uint8)
    mf[..., 1:-1, :, 1:-1] = FLUID
    mf[..., Z // 2, Y // 2, 2:4] = OBS
    tx = pp.tile_width(pl.k)
    for z in (pl.lz - 1, pl.lz):
        for y in (pl.ty - 1, pl.ty):
            for x in (tx - 1, tx):
                mf[..., z % Z, y % Y, x % X] = OBS
    h = rng.uniform(-0.1, 0.1, (1, 19, *res)).astype(np.float32)
    rhs = (rng.uniform(-1e-2, 1e-2, (1, 1, *res)) * (mf == FLUID)).astype(np.float32)
    return torch.from_numpy(h), torch.from_numpy(mf), torch.from_numpy(rhs)


@pytest.mark.parametrize("tau", [1.0, 0.8])
@pytest.mark.parametrize("n_iters", [30, 7])
@pytest.mark.parametrize("res,tile", [
    ((7, 30, 29), None),                 # the plan's own choice: 2 x 2 tiles
    ((5, 9, 37), (3, 4, 2)),             # tiles and chunks that divide nothing
    ((4, 11, 61), (2, 5, 3)),
    ((6, 7, 33), (4, 3, 4)),
    ((5, 16, 29), (2, 16, 5)),           # the tallest extended tile (18 rows)
])
def test_schedule_equals_plain_sweeps_bit_for_bit(res, tile, n_iters, tau):
    """``tile``: (k, ty, lz) of a plan built as ``--poisson-plans`` builds
    its plans, or None for :func:`plan`'s own."""
    if tile is None:
        pl = pp.plan(*res, n_iters, SMS)
    else:
        k, ty, lz = tile
        pl = pp.PoissonPlan(k, ty, lz, pp.passes(n_iters, k))
    h, mf, rhs = _inputs(res, sum(res) + n_iters, pl)
    got_h, got_psi = emulate(h, mf, rhs, n_iters, pl, tau)
    want_h, want_psi = pp.poisson_sweeps_plain(h, mf, rhs, tau=tau, n_iters=n_iters)
    assert torch.equal(got_h, want_h)
    assert torch.equal(got_psi, want_psi)


def test_one_sweep_plan_equals_plain_sweeps():
    """k = 1: the one-sweep kernel as a pass, at the plan's tile height (the
    one-sweep plan chip_smoke holds the chosen plan to)."""
    res = (5, 12, 40)
    pl = pp.PoissonPlan(k=1, ty=pp.TY, lz=2, passes=(1, 1, 1))
    h, mf, rhs = _inputs(res, 11, pl)
    got = emulate(h, mf, rhs, 3, pl, 0.8)
    want = pp.poisson_sweeps_plain(h, mf, rhs, tau=0.8, n_iters=3)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_schedule_at_a_deep_pass_wraps_a_small_grid():
    """k = 4 on a 3-plane grid: the window wraps z several times over."""
    res = (3, 6, 9)
    pl = pp.PoissonPlan(k=4, ty=2, lz=2, passes=(4, 4, 3))
    h, mf, rhs = _inputs(res, 3, pl)
    got = emulate(h, mf, rhs, 11, pl, 1.0)
    want = pp.poisson_sweeps_plain(h, mf, rhs, tau=1.0, n_iters=11)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
