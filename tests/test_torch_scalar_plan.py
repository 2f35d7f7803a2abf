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


def emulate_pass(s, s_prev, cmask, rhs, k, ty, lz):
    """One pass of ``k`` sweeps on [Z, Y, X] fields as lbm_scalar_pass
    schedules it: returns (s', s_prev', psi of the last sweep)."""
    Z, Y, X = cmask.shape
    tx, EX, EY = sp.EXT_WIDTH - 2 * k, sp.EXT_WIDTH, ty + 2 * k
    nan = float("nan")
    outs = [torch.full_like(s, nan) for _ in range(3)]
    for y0 in range(0, Y, ty):
        rows = (y0 - k + torch.arange(EY)) % Y
        for x0 in range(0, X, tx):
            cols = (x0 - k + torch.arange(EX)) % X

            def ext(f, w):
                return f[w % Z][rows][:, cols]

            for z0 in range(0, Z, lz):
                z1 = min(z0 + lz, Z)
                ring = {}
                for t in range(z0 - k, z1 + k):
                    ring[0, t % 3] = ext(s, t)
                    for j in range(1, k + 1):
                        w = t - j
                        if not z0 - k + j <= w < z1 + k - j:
                            continue
                        R, C = slice(j, EY - j), slice(j, EX - j)
                        prev = ext(s_prev, w)[R, C] if j == 1 else ring[j - 2, w % 3][R, C]
                        psi, new = _stage(ring[j - 1, w % 3], ring[j - 1, (w - 1) % 3],
                                          ring[j - 1, (w + 1) % 3], prev,
                                          ext(cmask, w)[R, C], ext(rhs, w)[R, C], j, EY, EX)
                        if j < k:
                            plane = torch.full((EY, EX), nan, dtype=s.dtype)
                            plane[R, C] = new
                            ring[j, w % 3] = plane
                            continue
                        ny, nx = min(ty, Y - y0), min(tx, X - x0)
                        last = ring[k - 1, w % 3][R, C]
                        for out, v in zip(outs, (new, last, psi)):
                            out[w, y0:y0 + ny, x0:x0 + nx] = v[:ny, :nx]
    return outs


def emulate(s2, cmask, rhs, n_iters, pl):
    """``n_iters`` sweeps as the plan's passes: (s2', psi)."""
    s, s_prev = s2[0, 0], s2[0, 1]
    cm, rh = cmask[0, 0], rhs[0, 0]
    psi = None
    for k in pl.passes:
        s, s_prev, psi = emulate_pass(s, s_prev, cm, rh, k, pl.ty, pl.lz)
    return torch.stack([s, s_prev])[None], psi[None, None]


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
