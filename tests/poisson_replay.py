"""B11b's pass schedule replayed in PyTorch, for the tests of its plan
(tests/test_torch_poisson_plan.py and the files beside it that hold the
schedule cases, ``test_torch_poisson_plan_*.py``).

The CUDA kernel (``csrc/poisson.cu:lbm_poisson_pass``) runs the channel-form
sweeps as passes of k sweeps, each a z-wavefront over tiles ``tile_width(k)``
x ty and z chunks of lz planes.  ``emulate`` replays its schedule: each tick
the input plane takes, through the wrapped column and row tables of the
extended tile, every channel's source plane of the plane stage 1 computes;
stage 1 pulls from it, each later stage from the ring of the stage before
it, whose slots keep the 9 channels with e_z = 0 for 2 planes, the 5 with
e_z = +1 for 3 and the 5 with e_z = -1 for 1; flags and rhs sit in a (k +
1)-plane ring; the last stage writes the tile.  Ring cells no stage has
written are NaN, and a slot still holds the plane it held before, so a read
of the wrong slot, row, column or plane shows.  The per-cell arithmetic is
``poisson.sweep_cell``, the plain version's, so the replay must equal
``poisson_sweeps_plain`` bit for bit.  In bfloat16 storage the rings take
h's dtype, as the kernel's.
"""

import numpy as np
import torch

from lbm_ferrofluid_tpu_torch.lattice import D3Q19
from lbm_ferrofluid_tpu_torch.ops.kernels import poisson as pp
from lbm_ferrofluid_tpu_torch.utils.types import widen

#: SMs of an H100 SXM
SMS = 132
OBS, FLUID = 2, 1


def emulate_pass(h, is_obs, rhs, k, ty, lz, tau):
    """One pass of ``k`` sweeps on [19, Z, Y, X] h as lbm_poisson_pass
    schedules it: returns (h', psi of the last sweep).  The input plane and
    the stage rings hold h's dtype (a stage's outputs are rounded to it
    where it stores them), and each sweep computes on their widened
    values."""
    _, Z, Y, X = h.shape
    ex, ey, ez = (D3Q19.e[:, a] for a in range(3))
    tx, hx, EW, EY = pp.tile_width(k), pp.halo_left(k), pp.EXT_WIDTH, ty + 2 * (k - 1)
    nan = float("nan")
    out = torch.full_like(h, nan)
    psi_out = torch.full_like(widen(h[:1]), nan)
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
                        new, psi = pp.sweep_cell(widen(s[None]),
                                                 fl_ring[p % (k + 1)][e][None, None],
                                                 rh_ring[p % (k + 1)][e][None, None], tau=tau)
                        new, psi = new[0], psi[0]
                        if j < k:
                            for g, n_slot, first in ((0, p % 2, 0), (1, p % 3, 9), (-1, 0, 14)):
                                n = 9 if g == 0 else 5
                                rings[j, g, n_slot][:, e] = new[first:first + n].to(h.dtype)
                            continue
                        ny, nx = min(ty, Y - y0), min(tx, X - x0)
                        tile = (slice(None), slice(0, ny), slice(hx, hx + nx))
                        out[:, zw, y0:y0 + ny, x0:x0 + nx] = new[tile].to(h.dtype)
                        psi_out[:, zw, y0:y0 + ny, x0:x0 + nx] = psi[tile]
    return out, psi_out


def emulate(h, flags, rhs, n_iters, pl, tau):
    """``n_iters`` sweeps as the plan's passes: (h', psi)."""
    is_obs = flags[0, 0] == OBS
    hh, psi = h[0], None
    for k in pl.passes:
        hh, psi = emulate_pass(hh, is_obs, rhs[0, 0], k, pl.ty, pl.lz, tau)
    return hh[None], psi[None]


def replay_inputs(res, seed, pl, dtype=torch.float32):
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
    return torch.from_numpy(h).to(dtype), torch.from_numpy(mf), torch.from_numpy(rhs)


SCHEDULES = [
    ((7, 30, 29), None),                 # the plan's own choice: 2 x 2 tiles
    ((5, 9, 37), (3, 4, 2)),             # tiles and chunks that divide nothing
    ((4, 11, 61), (2, 5, 3)),
    ((6, 7, 33), (4, 3, 4)),
    ((5, 16, 29), (2, 16, 5)),           # the tallest extended tile (18 rows)
]


def replay_against_plain(res, tile, n_iters, tau, dtype):
    """``tile``: (k, ty, lz) of a plan built as ``--poisson-plans`` builds
    its plans, or None for :func:`plan`'s own (for h's element size)."""
    if tile is None:
        pl = pp.plan(*res, n_iters, SMS, 2 if dtype == torch.bfloat16 else 4)
    else:
        k, ty, lz = tile
        pl = pp.PoissonPlan(k, ty, lz, pp.passes(n_iters, k))
    h, mf, rhs = replay_inputs(res, sum(res) + n_iters, pl, dtype)
    got_h, got_psi = emulate(h, mf, rhs, n_iters, pl, tau)
    want_h, want_psi = pp.poisson_sweeps_plain(h, mf, rhs, tau=tau, n_iters=n_iters)
    assert got_h.dtype == want_h.dtype == dtype and want_psi.dtype == torch.float32
    assert torch.equal(got_h, want_h)
    assert torch.equal(got_psi, want_psi)
