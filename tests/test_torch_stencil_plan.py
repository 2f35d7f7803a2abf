"""B10a's and B10b's z-walking schedule, on the CPU.

The CUDA kernel (``csrc/stencil3d.cu:lbm_stencil_kernel``) runs both
stencils as one template: a block owns a tx x ty tile of ``plan`` (one of
``TILES``, ry rows a thread) and walks a strip of zb planes.  It keeps the
tile and a 1-cell halo of each field in a 4-plane ring (slot p % 4), whose
rows and columns start at ``lbm_ring_origin``; each thread loads ry ring
cells of a plane (column tx + 1, rows r tt + ty + 1) and at most one halo
cell (rows 0 and ty + 1, then columns 0 and tx + 1), into registers one
plane before they reach the ring.  A cell taps the ring around the nearest
interior cell (clamped in z, y and x); B10a writes the gradients there,
B10b a zero on the boundary ring and the Laplacian elsewhere.  B10a takes
at most ``MAX_FIELDS`` fields a launch (``chunks``).

It cannot run here, so ``replay`` walks the same schedule in PyTorch: every
block, every thread's loads in the same order into rings that start as NaN,
the same slots, offsets and chunks.  A read of a slot, row, column or
plane the kernel would not have filled shows as NaN or as a wrong value,
and a plane stored over one that a cell still taps after the last barrier
fails an assertion (the kernel has one barrier a plane).  The per-cell
arithmetic is the plain version's, so the replay must equal it bit for
bit, in float32 and float64.
"""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lbm_ferrofluid_tpu_torch.ops.kernels import stencil3d  # noqa: E402

#: SMs of an H100 SXM
SMS = 132


def clamp(i, lo, hi):
    return min(max(i, lo), hi)


def iso_sums(S):
    """common.cuh:lbm_iso_sums: the 19-point gradient's numerators."""
    gx = 2.0 * (S(0, 0, 1) - S(0, 0, -1)) + (
        S(1, 0, 1) - S(-1, 0, -1) + S(-1, 0, 1) - S(1, 0, -1) + S(0, 1, 1) - S(0, -1, -1)
        + S(0, -1, 1) - S(0, 1, -1))
    gy = 2.0 * (S(0, 1, 0) - S(0, -1, 0)) + (
        S(1, 1, 0) - S(-1, -1, 0) + S(-1, 1, 0) - S(1, -1, 0) + S(0, 1, 1) - S(0, -1, -1)
        + S(0, 1, -1) - S(0, -1, 1))
    gz = 2.0 * (S(1, 0, 0) - S(-1, 0, 0)) + (
        S(1, 1, 0) - S(-1, -1, 0) + S(1, -1, 0) - S(-1, 1, 0) + S(1, 0, 1) - S(-1, 0, -1)
        + S(1, 0, -1) - S(-1, 0, 1))
    return gx, gy, gz


def laplacian(S, dx):
    """common.cuh:lbm_laplacian."""
    faces = S(0, 0, 1) + S(0, 0, -1) + S(0, 1, 0) + S(0, -1, 0) + S(1, 0, 0) + S(-1, 0, 0)
    edges = (S(0, 1, 1) + S(0, 1, -1) + S(0, -1, 1) + S(0, -1, -1) + S(1, 0, 1) + S(1, 0, -1)
             + S(-1, 0, 1) + S(-1, 0, -1) + S(1, 1, 0) + S(1, -1, 0) + S(-1, 1, 0)
             + S(-1, -1, 0))
    return (2.0 * faces + edges - 24.0 * S(0, 0, 0)) / (6.0 * dx * dx)


def thread_loads(tx, ty, ry):
    """(ey, ex) of the ring cells a block's threads load each plane, in
    thread order: each thread's ry cells, then its halo cell."""
    tt, ey_n, ex_n = ty // ry, ty + 2, tx + 2
    nh = 2 * tx + 2 * ey_n
    assert nh <= tx * tt
    cells = []
    for tid in range(tx * tt):
        t_y, t_x = divmod(tid, tx)
        cells += [(r * tt + t_y + 1, t_x + 1) for r in range(ry)]
        if tid < 2 * tx:
            cells.append((0 if tid < tx else ey_n - 1, (tid if tid < tx else tid - tx) + 1))
        elif tid < nh:
            c = tid - 2 * tx
            cells.append((c if c < ey_n else c - ey_n, 0 if c < ey_n else ex_n - 1))
    return cells


def replay_launch(x, out, f0, n, pl, ry, dx, lap):
    """One launch of ``lbm_stencil_kernel`` on fields f0..f0 + n of ``x``
    under the plan ``pl``, writing ``out`` (channels 3 f0.. for B10a)."""
    _, _, Z, Y, X = x.shape
    tx, ty, zb = pl
    ey, ex = (torch.tensor(v) for v in zip(*thread_loads(tx, ty, ry)))
    nan = float("nan")
    for bz in range(-(-Z // zb)):
        for by in range(-(-Y // ty)):
            for bx in range(-(-X // tx)):
                x0, y0, z0 = bx * tx, by * ty, bz * zb
                z1 = min(z0 + zb, Z)
                rx0, ry0 = clamp(x0, 1, X - 2) - 1, clamp(y0, 1, Y - 2) - 1
                gy = torch.clamp(ry0 + ey, 0, Y - 1)
                gx = torch.clamp(rx0 + ex, 0, X - 1)
                ring = torch.full((4, n, ty + 2, tx + 2), nan, dtype=x.dtype)
                # the planes each slot holds, the last step that tapped
                # each plane, and the step of the last barrier
                held, tapped, barrier, step = {}, {}, -1, 0

                def fetch(p):
                    return x[0, f0:f0 + n, p, gy, gx]

                def put(p, v):
                    old = held.get(p & 3)
                    assert old is None or tapped.get(old, -1) < barrier, \
                        f"plane {p} stored over plane {old}, tapped after the last barrier"
                    held[p & 3] = p
                    ring[p & 3, :, ey, ex] = v

                xs = torch.arange(x0, min(x0 + tx, X))
                ys = torch.arange(y0, min(y0 + ty, Y))
                xl = (torch.clamp(xs, 1, X - 2) - rx0)[None, :]
                yl = (torch.clamp(ys, 1, Y - 2) - ry0)[:, None]
                ring_xy = ((xs[None, :] == 0) | (xs[None, :] == X - 1)
                           | (ys[:, None] == 0) | (ys[:, None] == Y - 1))
                lo, last = clamp(z0, 1, Z - 2) - 1, clamp(z1 - 1, 1, Z - 2) + 1
                v, w = fetch(lo), fetch(lo + 1)
                put(lo, v)
                put(lo + 1, w)
                v = fetch(lo + 2)
                hi = lo + 1
                for z in range(z0, z1):
                    step += 1
                    zc = clamp(z, 1, Z - 2)
                    if zc + 1 > hi:
                        hi += 1
                        put(hi, v)
                        if hi + 1 <= last:
                            v = fetch(hi + 1)
                        barrier = step
                    for p in (zc - 1, zc, zc + 1):
                        assert held.get(p & 3) == p, f"plane {p} not in the ring at z = {z}"
                        tapped[p] = step
                    for f in range(n):
                        def S(oz, oy, ox, f=f):
                            return ring[(zc + oz) & 3, f, yl + oy, xl + ox]

                        if lap:
                            val = laplacian(S, dx)
                            zero = ring_xy | (z != zc)
                            out[0, 0, z, ys[:, None], xs[None, :]] = torch.where(
                                zero, torch.zeros((), dtype=x.dtype), val)
                        else:
                            for d, g in enumerate(iso_sums(S)):
                                out[0, 3 * (f0 + f) + d, z, ys[:, None], xs[None, :]] = \
                                    g / (12.0 * dx)


def replay(x, pl, dx, lap=False):
    """B10a (or B10b with ``lap``) as the kernel schedules it under the
    tile and strip of ``pl``, chunk by chunk."""
    _, n_fields, Z, Y, X = x.shape
    ry = {(a, b): r for a, b, r in stencil3d.TILES}[(pl.tx, pl.ty)]
    out = torch.full((1, 1 if lap else 3 * n_fields, Z, Y, X), float("nan"), dtype=x.dtype)
    f0 = 0
    for n in [1] if lap else stencil3d.chunks(n_fields):
        replay_launch(x, out, f0, n, pl, ry, dx, lap)
        f0 += n
    return out


#: (grid, strip): None takes ``plan``'s.  Last tiles holding only the last
#: cell (33 = 32 + 1 and 65 = 64 + 1 in x, 9 = 8 + 1 and 17 = 16 + 1 in y),
#: 66 = 2 x 32 + 2, strips that end at Z - 1 and of one plane, Z = 4 (the z
#: clamp at both strip ends)
CASES = [
    ((4, 9, 33), None),
    ((5, 17, 65), 2),
    ((7, 10, 34), 3),
    ((6, 9, 129), 5),
    ((9, 18, 66), 4),
    ((4, 8, 16), 1),
]
KINDS = ["grad1", "grad3", "grad4", "grad5", "lap"]


#: (tile, kind) pairs the kernel is built for: every chunk's instance fits
BUILT = [(t[:2], kind) for t in stencil3d.TILES for kind in KINDS
         if all(stencil3d.fits(*t[:2], c)
                for c in ([1] if kind == "lap" else stencil3d.chunks(int(kind[4:]))))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("tile,kind", BUILT, ids=[f"{t[0]}x{t[1]}-{k}" for t, k in BUILT])
@pytest.mark.parametrize("res,zb", CASES,
                         ids=["x".join(map(str, r)) + f"-zb{zb or 'plan'}" for r, zb in CASES])
def test_schedule_equals_plain(res, zb, tile, kind, dtype):
    lap = kind == "lap"
    n = 1 if lap else int(kind[4:])
    rng = np.random.default_rng(sum(res) + n)
    x = torch.from_numpy(rng.standard_normal((1, n, *res))).to(dtype)
    dx = 0.7
    chunk = min(n, stencil3d.MAX_FIELDS)
    pl = stencil3d.StencilPlan(*tile, zb or stencil3d.plan(*res, SMS, chunk, laplacian=lap).zb)
    got = replay(x, pl, dx, lap)
    want = (stencil3d.laplacian_field_plain(x, dx=dx) if lap
            else stencil3d.grad_fields_plain(x, dx=dx))
    assert not torch.isnan(got).any(), "a cell was never written or read an empty ring cell"
    assert torch.equal(got, want)
    # the wrapper on CPU tensors is the plain version
    wrapper = stencil3d.laplacian_field if lap else stencil3d.grad_fields
    assert torch.equal(wrapper(x, dx=dx), want)


def test_kernel_tiles_are_the_cuda_sources():
    """TILES is ST_TILES of csrc/stencil3d.cu, which instantiates the
    kernel; SMEM_MAX its ST_SMEM_MAX, MAX_FIELDS its ST_MAX_FIELDS and
    ``min_blocks`` its launch bounds' ST_MIN_BLOCKS."""
    src = (Path(stencil3d.__file__).parents[2] / "csrc" / "stencil3d.cu").read_text()
    line = re.search(r"#define ST_TILES\(M\) (.*)", src)[1]
    tiles = tuple(tuple(int(v) for v in t)
                  for t in re.findall(r"M\((\d+), (\d+), (\d+)\)", line))
    assert tiles == stencil3d.TILES
    assert int(re.search(r"#define ST_MAX_FIELDS (\d+)", src)[1]) == stencil3d.MAX_FIELDS
    assert int(re.search(r"#define ST_SMEM_MAX (\d+)", src)[1]) == stencil3d.SMEM_MAX
    lap, few, many, fewer = (int(v) for v in re.search(
        r"#define ST_MIN_BLOCKS\(NF, LAP\) \(\(LAP\) \? (\d+) : \(NF\) <= (\d+) \? (\d+) : "
        r"(\d+)\)", src).groups())
    assert stencil3d.min_blocks(1, laplacian=True) == lap
    for n in range(1, stencil3d.MAX_FIELDS + 1):
        assert stencil3d.min_blocks(n) == (many if n <= few else fewer)
    # the tiles plan takes are built for their field counts (0: the
    # Laplacian, one field)
    assert set(stencil3d.SHAPES) == set(range(stencil3d.MAX_FIELDS + 1))
    for n, (tile, longest) in stencil3d.SHAPES.items():
        assert tile in {t[:2] for t in tiles} and stencil3d.fits(*tile, max(n, 1))
        assert longest >= 1
    assert stencil3d.SMEM_MAX <= 48 * 1024
    for tx, ty, ry in tiles:
        threads = tx * ty // ry
        # one halo cell a thread, whole warps and 2048 threads an SM
        assert stencil3d.fits(tx, ty, 1) and ty % ry == 0 and 2 * tx + 2 * (ty + 2) <= threads
        assert threads % 32 == 0 and threads * stencil3d.min_blocks(1) <= 2048


GRIDS = [(256, 256, 256), (130, 66, 130), (130, 130, 130), (50, 50, 193), (4, 8, 16),
         (4, 66, 130)]


@pytest.mark.parametrize("lap", [False, True], ids=["grad", "lap"])
@pytest.mark.parametrize("res", GRIDS, ids=lambda r: "x".join(map(str, r)))
def test_plan_covers_the_grid(res, lap):
    Z, Y, X = res
    for n in (1, 2, 3, 4):
        pl = stencil3d.plan(Z, Y, X, SMS, n, laplacian=lap)
        tile, longest = stencil3d.SHAPES[0 if lap else n]
        assert (pl.tx, pl.ty) == tile and 1 <= pl.zb <= min(Z, longest)
        # tiles and strips cover the grid, the last strip ends at Z - 1
        nx, ny, nz = -(-X // pl.tx), -(-Y // pl.ty), -(-Z // pl.zb)
        assert (nx - 1) * pl.tx < X <= nx * pl.tx and (ny - 1) * pl.ty < Y <= ny * pl.ty
        assert (nz - 1) * pl.zb < Z and min((nz - 1) * pl.zb + pl.zb, Z) - 1 == Z - 1


@pytest.mark.parametrize("n,launches", [(1, 1), (2, 1), (3, 1), (4, 1), (5, 2), (8, 2),
                                        (9, 3)])
def test_launches_per_call(n, launches):
    assert stencil3d.launches_per_call(n) == launches
    assert sum(stencil3d.chunks(n)) == n and max(stencil3d.chunks(n)) <= stencil3d.MAX_FIELDS


def test_plan_takes_the_swept_shapes_at_256():
    """The plans the card was timed at (--stencil-plans, 256^3): the
    Laplacian on 64 x 16 tiles (6 blocks an SM) in 7-plane strips (2368
    blocks: 2.99 waves of 792), one field on 64 x 8 tiles in 8-plane
    strips (4096 blocks: 3.9 waves of 1056), three fields on 64 x 8 and
    four on 32 x 8 tiles (5 blocks an SM) in 4-plane strips."""
    shapes = {n: stencil3d.plan(256, 256, 256, SMS, max(n, 1), laplacian=n == 0)
              for n in (0, 1, 3, 4)}
    assert shapes == {0: (64, 16, 7), 1: (64, 8, 8), 3: (64, 8, 4), 4: (32, 8, 4)}
    assert stencil3d.blocks_per_sm(64, 16, 1, laplacian=True) == 6
    assert stencil3d.blocks_per_sm(64, 8, 3) == stencil3d.blocks_per_sm(32, 8, 4) == 5
    # a card of half the SMs takes strips that fill its own waves
    assert stencil3d.plan(256, 256, 256, SMS // 2, 1).zb == 7
