"""B7's trailing stage (``emit="hint"``, ``emit="h2"``) in B11b's last pass, on
the CPU.

The JAX package's single-device solve runs the TPU wavefront with a trailing
stage that substitutes psi's magnetic obstacles, takes the 18-tap isotropic
gradient and replicates the output's boundary ring, two planes behind the
final sweep, and writes H_int or the Kelvin magnitude H2 instead of psi
(``ops/pallas/poisson.py:_wavefront_kernel`` :1150-1162, :1203-1266).  The
port's ``poisson_sweeps(..., emit=)`` does the same in the last pass of its
kernel (``csrc/poisson_trail.cu:lbm_poisson_trail_kernel``); ``trail_plain`` is the
plain version.  Bars, each with its reason:

* The plain modes against JAX's ``poisson_wavefront(emit=, interpret=True)``
  at 8x8x16, 4 sweeps, magnetic obstacles on the z edge planes, the x edge
  columns, the y ring and inside: rel <= 1e-6 with h in float32 and in
  bfloat16 (measured at most 2.9e-7 and 2.0e-7: the same taps in the same
  order, on psi that differs by XLA's FMA contraction of the sweeps), where
  the composition's bar is 2e-5 (tests/test_torch_poisson.py).
* The plain modes against the psi route (``h_int_from_psi`` with
  ``grad_fields_plain``): rel <= 1e-6 in float32 (the trailing stage
  multiplies by f32(-1/(12 dx)) where B10a's plain version divides its
  grouped sums by 12 dx), rel <= 1e-12 in float64.
* A replay of the trailing pass's schedule (tiles of a pass of k + 1
  sweeps, the grid's last column and row with the tile before them, z
  chunks, the source of each output cell, the 4-plane psi and flags rings
  with cells that stage k does not compute as NaN, the stage one tick
  behind, a warp a row): bit for bit to ``trail_plain``, every output cell
  and every h' cell written exactly once; its warps' loads of the input
  plane cover what stage 1 reads.
* ``solve_H_int`` in 3D and one capillogue steady-state step in channel
  form against the JAX package, at tests/test_torch_poisson.py's and
  tests/test_torch_parallel_channel.py's bars.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_mesh_worker as worker  # noqa: E402
from lbm_ferrofluid_tpu.lattice import D3Q19 as JD3Q19  # noqa: E402
from lbm_ferrofluid_tpu.models import SimulationParams as JParams  # noqa: E402
from lbm_ferrofluid_tpu.models import ferrofluid_step as jstep  # noqa: E402
from lbm_ferrofluid_tpu.models import init_ferrofluid_state as jinit  # noqa: E402
from lbm_ferrofluid_tpu.ops import magnetic as jmagnetic  # noqa: E402
from lbm_ferrofluid_tpu.ops.pallas import poisson as jpoisson  # noqa: E402

from lbm_ferrofluid_tpu_torch.lattice import D3Q19  # noqa: E402
from lbm_ferrofluid_tpu_torch.ops import solve_H_int  # noqa: E402
from lbm_ferrofluid_tpu_torch.ops.kernels import poisson as pp  # noqa: E402
from lbm_ferrofluid_tpu_torch.ops.kernels.stencil3d import grad_fields_plain  # noqa: E402
from lbm_ferrofluid_tpu_torch.ops.magnetic import h_int_from_psi  # noqa: E402

OBS, FLUID = 2, 1
RES = (8, 8, 16)
H_EXT = (0.0, 85.0, 0.0)
BARS = {"float32": 1e-6, "bfloat16": 1e-6}


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def T(x):
    return torch.from_numpy(np.array(x))


def _mflags(res):
    """The Rosensweig magnetic shell (z edge planes, x edge columns), an
    interior block, and obstacles on the y ring (y = 0 and Y - 1)."""
    Z, Y, X = res
    mf = np.full((1, 1, *res), OBS, np.uint8)
    mf[..., 1:-1, :, 1:-1] = FLUID
    mf[..., Z // 2 - 1:Z // 2 + 1, Y // 2 - 1:Y // 2 + 1, 5:7] = OBS
    mf[..., 2, 0, 3:6] = OBS
    mf[..., Z - 3, Y - 1, X - 5:X - 2] = OBS
    return mf


def _inputs(res, seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    mf = _mflags(res)
    h = rng.uniform(-0.1, 0.1, (1, 19, *res)).astype(np.float32)
    rhs = (rng.uniform(-1e-2, 1e-2, (1, 1, *res)) * (mf == FLUID)).astype(np.float32)
    return h.astype(dtype), mf, rhs.astype(dtype)


def _emit_kw(emit):
    return dict(emit=emit, dx=1.0, h_ext=H_EXT if emit == "h2" else None)


# ---------------------------------------------------------------- against JAX
@pytest.mark.parametrize("dtype", sorted(BARS))
@pytest.mark.parametrize("tau", [1.0, 0.8])
@pytest.mark.parametrize("emit", ["hint", "h2"])
def test_emit_plain_matches_jax_wavefront(emit, tau, dtype):
    h, mf, rhs = _inputs(RES, 1, np.float32)
    jkw = dict(emit=emit, dx=1.0, **({"h_ext": H_EXT} if emit == "h2" else {}))
    jh = jnp.asarray(h).astype(jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    _, jout = jpoisson.poisson_wavefront(jh, jnp.asarray(mf), jnp.asarray(rhs), tau=tau,
                                         n_iters=4, interpret=True, **jkw)
    th = T(h).to(getattr(torch, dtype))
    ph, out = pp.poisson_sweeps_plain(th, T(mf), T(rhs), tau=tau, n_iters=4, **_emit_kw(emit))
    assert ph.dtype == th.dtype and out.dtype == torch.float32
    assert tuple(out.shape) == tuple(jout.shape) == (1, 3 if emit == "hint" else 1, *RES)
    assert rel(out, jout) <= BARS[dtype]
    # the wrapper on CPU tensors is the plain version
    hk, outk = pp.poisson_sweeps(th, T(mf), T(rhs), tau=tau, n_iters=4, **_emit_kw(emit))
    assert torch.equal(hk, ph) and torch.equal(outk, out)


@pytest.mark.parametrize("dtype,bar", [(np.float32, 1e-6), (np.float64, 1e-12)])
@pytest.mark.parametrize("tau", [1.0, 0.8])
@pytest.mark.parametrize("emit", ["hint", "h2"])
def test_emit_plain_matches_psi_route(emit, tau, dtype, bar):
    """The trailing stage against psi, the substitution and B10a's plain
    version, which divides by 12 dx: the same field to an ulp; h' bit for
    bit."""
    h, mf, rhs = _inputs((6, 9, 11), 2, dtype)
    kw = dict(tau=tau, n_iters=5)
    ph, out = pp.poisson_sweeps_plain(T(h), T(mf), T(rhs), **kw, **dict(_emit_kw(emit), dx=0.5))
    h_psi, psi = pp.poisson_sweeps_plain(T(h), T(mf), T(rhs), **kw)
    want = h_int_from_psi(psi, T(mf), dx=0.5, h2_ext=H_EXT if emit == "h2" else None,
                          grad=grad_fields_plain)
    assert torch.equal(ph, h_psi)
    assert out.dtype == psi.dtype and out.shape == want.shape
    assert rel(out, want) <= bar


@pytest.mark.parametrize("dtype,bar", [(np.float32, 1e-6), (np.float64, 1e-12)])
@pytest.mark.parametrize("h2_ext", [H_EXT, None], ids=["h2", "hint"])
def test_solve_H_int_matches_jax(h2_ext, dtype, bar):
    """``solve_H_int`` in 3D (one call, the trailing stage) against the JAX
    package's jnp body, which composes psi, the substitution and the
    gradient: tests/test_torch_poisson.py's bars."""
    h, mf, rhs = _inputs(RES, 3, dtype)
    jH, jh = jmagnetic.solve_H_int(JD3Q19, jnp.asarray(h), None, jnp.asarray(mf), None,
                                   tau=0.8, n_iters=4, use_pallas=False,
                                   rhs_scaled=jnp.asarray(rhs), h2_ext=h2_ext)
    pH, ph = solve_H_int(D3Q19, T(h), None, T(mf), None, tau=0.8, n_iters=4,
                         rhs_scaled=T(rhs), h2_ext=h2_ext)
    assert pH.shape == tuple(jH.shape) and pH.dtype == T(h).dtype
    assert rel(ph, jh) <= bar
    assert rel(pH, jH) <= bar
    # the same call through the plain versions on any device
    qH, qh = solve_H_int(D3Q19, T(h), None, T(mf), None, tau=0.8, n_iters=4,
                         rhs_scaled=T(rhs), h2_ext=h2_ext, plain=True)
    assert torch.equal(qH, pH) and torch.equal(qh, ph)


def test_solve_H_int_takes_the_psi_route_without_an_interior():
    """A grid with 2 cells in y has no interior row for the output ring:
    ``emit_ok`` refuses the trailing stage, and ``solve_H_int`` composes
    psi, the substitution and the gradient, as before."""
    res = (6, 2, 9)
    h, mf, rhs = _inputs(res, 4, np.float32)
    assert not pp.emit_ok((1, 19, *res)) and pp.emit_ok((1, 19, 6, 3, 9))
    pH, ph = solve_H_int(D3Q19, T(h), None, T(mf), None, tau=0.8, n_iters=3,
                         rhs_scaled=T(rhs), h2_ext=H_EXT)
    h_psi, psi = pp.poisson_sweeps_plain(T(h), T(mf), T(rhs), tau=0.8, n_iters=3)
    want = h_int_from_psi(psi, T(mf), dx=1.0, h2_ext=H_EXT, grad=grad_fields_plain)
    assert torch.equal(ph, h_psi) and torch.equal(pH, want)
    with pytest.raises(ValueError, match="Y, X >= 3"):
        pp.poisson_sweeps_plain(T(h), T(mf), T(rhs), tau=0.8, n_iters=3, **_emit_kw("h2"))


def test_channel_step_matches_jax():
    """One capillogue steady-state step in channel form (tau 0.8, primed,
    19-channel h: the solve's trailing stage emits H2) against the JAX
    package's step of the unprimed state (its un-carried step, the same
    fields), at tests/test_torch_parallel_channel.py's bars."""
    params, s, step = worker.route_state("C", 3)
    s = step(params, worker.prime_route(params, s, "C", device="cpu"), device="cpu")
    kw, fields = worker.channel_config("C")
    jparams = JParams(poisson_iters=3, **kw).replace(use_pallas=False)
    js = jstep(jparams, jinit(jparams, *fields))
    assert s.h.shape[1] == 19
    for name in ("f", "g", "h", "rho", "vel", "density", "pressure"):
        np.testing.assert_allclose(getattr(s, name).numpy(), np.asarray(getattr(js, name)),
                                   rtol=2e-5, atol=1e-6, err_msg=name)


# ---------------------------------------------------------------- the plan
def test_trail_limits_are_the_cuda_sources():
    """``TRAIL_EXT_HEIGHTS`` and ``TRAIL_MAX_K`` are csrc/poisson_trail.cu's
    PP_TRAIL_HEIGHTS and PP_TRAIL_MAX_K; the trailing pass of every k up to
    it fits the shared memory in float32 and bfloat16 on ``TY``-row tiles."""
    src = (Path(pp.__file__).parents[2] / "csrc" / "poisson_trail.cu").read_text()
    line = re.search(r"#define PP_TRAIL_HEIGHTS\(M\) (.*)", src)[1]
    assert tuple(int(e) for e in re.findall(r"M\((\d+)\)", line)) == pp.TRAIL_EXT_HEIGHTS
    assert int(re.search(r"#define PP_TRAIL_MAX_K (\d+)", src)[1]) == pp.TRAIL_MAX_K
    for k in range(1, pp.TRAIL_MAX_K + 1):
        for elem in (4, 2):
            pl = pp.trail_pass(256, 256, 256, k, 132, elem)
            assert pl.ty + 2 * k in pp.TRAIL_EXT_HEIGHTS and pl.passes == (k,)
            assert pp.smem_bytes(k, pl.ty, elem, trail=True) <= pp.SMEM_BLOCK_MAX
    # the trailing stage adds a psi (4 B) and a flags (1 B) plane of 4 slots
    # to the block of a pass with two more extended rows
    assert pp.smem_bytes(3, 9, trail=True) == pp.smem_bytes(3, 11) + 20 * 32 * 15
    head = (Path(pp.__file__).parents[2] / "csrc" / "poisson_pass.cuh").read_text()
    assert int(re.search(r"#define PP_TRAIL_SLOTS (\d+)", head)[1]) == pp.TRAIL_SLOTS
    # the call's own plan ends on a pass the trailing stage runs
    for n in (1, 2, 7, 29, 30):
        pp.trail_pass(130, 66, 130, pp.plan(130, 66, 130, n, 132).passes[-1], 132)
    with pytest.raises(ValueError, match="1 <= k <= 3"):
        pp.trail_pass(130, 66, 130, 4, 132)


@pytest.mark.parametrize("Y,X", [(66, 130), (10, 25)])
def test_trail_chunks_keep_edge_planes_with_their_sources(Y, X):
    """No chunk of the trailing pass is a z edge plane alone (the stage at
    plane 1 writes plane 0, at Z - 2 plane Z - 1)."""
    for Z in range(2, 70):
        lz = pp.trail_pass(Z, Y, X, 3, 132).lz
        assert lz == Z or (lz >= 2 and Z % lz != 1), (Z, lz)
        for sms in (16, 66):
            lz = pp.trail_pass(Z, Y, X, 2, sms).lz
            assert lz == Z or (lz >= 2 and Z % lz != 1), (Z, lz, sms)


def test_cost_counts_the_emitted_channels():
    h, mf, rhs = _inputs(RES, 5, np.float32)
    args = (T(h), T(mf), T(rhs))
    kw = dict(tau=0.8, n_iters=30)
    n = int(np.prod(RES))
    psi = pp.cost(*args, **kw)
    hint = pp.cost(*args, emit="hint", **kw)
    h2 = pp.cost(*args, emit="h2", h_ext=H_EXT, **kw)
    interior = (RES[0] - 2) * (RES[1] - 2) * (RES[2] - 2)
    assert hint[0] - psi[0] == 8 * n and h2[0] == psi[0]
    assert hint[1] - psi[1] == 33 * interior and h2[1] - psi[1] == (33 + 6) * interior


def test_emit_arguments_are_checked():
    h, mf, rhs = (T(a) for a in _inputs(RES, 6, np.float32))
    kw = dict(tau=0.8, n_iters=3)
    with pytest.raises(ValueError, match="h_ext"):
        pp.poisson_sweeps(h, mf, rhs, emit="h2", **kw)
    with pytest.raises(ValueError, match="not 'H2'"):
        pp.poisson_sweeps(h, mf, rhs, emit="H2", **kw)
    with pytest.raises(ValueError, match="none on one device"):
        pp.poisson_sweeps(h, mf, rhs, emit="hint", clamp=(1, 6), **kw)
    with pytest.raises(ValueError, match="trailing stage's"):
        pp.poisson_sweeps(h, mf, rhs, clamp=(1, 6), **kw)
    G = 3
    ghosts = (h[:, :, -G:], h[:, :, :G])
    ext = torch.cat([mf[:, :, -G:], mf, mf[:, :, :G]], dim=2)
    rext = torch.cat([rhs[:, :, -G:], rhs, rhs[:, :, :G]], dim=2)
    with pytest.raises(ValueError, match="G >= k \\+ 1"):
        pp.poisson_sweeps(h, ext, rext, ghosts=ghosts, emit="hint", clamp=(-1, 8), **kw)
    with pytest.raises(ValueError, match="slab clamp"):
        pp.poisson_sweeps(h, ext, rext, ghosts=ghosts, emit="hint", clamp=(0, 8), tau=0.8,
                          n_iters=2)
    with pytest.raises(ValueError, match="no emit_bands"):
        pp.poisson_sweeps(h, ext, rext, ghosts=ghosts, emit="hint", clamp=(-1, 8), tau=0.8,
                          n_iters=2, emit_bands=True)


# ---------------------------------------------------------------- replay
#: D3Q19's e_y (stage 1 at extended row e reads channel q at row e - e_y(q))
EY_Q = [int(v) for v in D3Q19.e[:, 1]]


def trail_loads(ey):
    """{(extended row, channel): warp} as the trailing pass's warps load
    its input plane (csrc/poisson_pass.cuh, TRAIL): warp w row w, every
    channel; warp 0 also row -1 and warp ey - 1 row ey, the channels with
    e_y = +1 and -1."""
    loads = {}
    for w in range(ey):
        for q in range(19):
            loads[w, q] = w
    for q in range(19):
        if EY_Q[q] == 1:
            loads[-1, q] = 0
        if EY_Q[q] == -1:
            loads[ey, q] = ey - 1
    return loads


def emulate_trail(psi_ext, obs_ext, k, ty, lz, clamp, dx, emit, h_ext):
    """The trailing stage of a pass of ``k`` sweeps as
    ``lbm_poisson_trail_kernel`` schedules it, on psi and the magnetic
    obstacles of grid planes -1..Z (``psi_ext``, ``obs_ext`` [Z + 2, Y, X]):
    returns (output [C, Z, Y, X], times each output cell was written, times
    each h' cell was written).  Each block (a tile of the geometry of a pass
    of k + 1 sweeps and a z chunk) walks its ticks: stage k writes psi and
    the flags of block plane r - k + 1 into slot (r - k + 1) mod 4 of its
    rings, rows [k - 1, EY - k + 1) of its extended tile (wrapped through
    the grid), psi exact on lanes [k, 32 - k) and NaN on the rest; the other
    rows keep what the slot held, and a slot no stage wrote is NaN (flags
    unknown).  The trailing stage of block plane r - k - 1 runs at the start
    of tick r on the rings as they are, before stage k's store, a warp a row
    (warp w row w of the tile, w <= ty); a slot that stage k writes in the
    same tick reads NaN.  At each output cell it takes the taps at its
    source as the kernel does: psi, or at an obstacle psi of the clamped
    cell on the clamped plane."""
    Zp, Y, X = psi_ext.shape
    Z = Zp - 2
    zlo, zhi = clamp
    kg, slots = k + 1, pp.TRAIL_SLOTS
    tx, hx, ey, ew = pp.tile_width(kg), pp.halo_left(kg), ty + 2 * k, pp.EXT_WIDTH
    assert ty + 1 <= ey  # a warp for each row of the stage
    nan = float("nan")
    out = torch.full((3 if emit == "hint" else 1, Z, Y, X), nan)
    writes = torch.zeros((Z, Y, X), dtype=torch.int64)
    h_writes = torch.zeros((Z, Y, X), dtype=torch.int64)
    m = torch.tensor(-1.0 / (12.0 * dx), dtype=torch.float32)
    lanes, rows = torch.arange(ew), torch.arange(ey)
    stage_k = (rows >= k - 1) & (rows < ey - k + 1)
    exact = stage_k[:, None] & ((lanes >= k) & (lanes < ew - k))[None, :]
    warps = torch.arange(ty + 1)

    for y0 in range(0, Y - 1, ty):
        rowy = (y0 - kg + 1 + rows) % Y
        yo_h = y0 + rows - (kg - 1)
        row_h = (rows >= kg - 1) & (yo_h < Y) & ((rows < kg - 1 + ty) | (
            (rows == kg - 1 + ty) & (yo_h == Y - 1)))
        for x0 in range(0, X - 1, tx):
            colx = (x0 - hx + lanes) % X
            xo = x0 + lanes - hx
            col = (lanes >= hx) & (xo < X) & ((lanes < hx + tx) | ((lanes == hx + tx) & (
                xo == X - 1)))
            sx = torch.clamp(torch.clamp(xo, max=X - 2), min=1)
            for z0 in range(0, Z, lz):
                z1 = min(z0 + lz, Z)
                n_ticks = z1 - z0 + 2 * k
                # h': stage k's cells of the tile and the last column and row
                cells = row_h[:, None] & col[None, :]
                for z in range(z0, z1):
                    h_writes[z, yo_h[:, None].expand_as(cells)[cells],
                             xo[None, :].expand_as(cells)[cells]] += 1
                ring = [torch.full((ey, ew), nan) for _ in range(slots)]
                ring_obs = [torch.full((ey, ew), nan) for _ in range(slots)]

                def trail(ps, busy):
                    zs = z0 + ps - k
                    if not zlo <= zs <= zhi:
                        return
                    # slots of planes zs - 1, zs, zs + 1, and of the planes
                    # the substitution clamps them to
                    sl = [(ps + oz) % slots for oz in (-1, 0, 1)]
                    sc = [sl[1] if zs == zlo else sl[0], sl[1], sl[1] if zs == zhi else sl[2]]
                    # warp w, row w of the tile: rows 0..ty at once
                    e, yo = k + warps, y0 + warps
                    ok = ((yo < Y) & ((warps < ty) | (yo == Y - 1)))[:, None] & col[None, :]
                    sy = torch.clamp(torch.clamp(yo, max=Y - 2), min=1)
                    H = []
                    for taps in pp.GRAD_TAPS:
                        acc = None
                        for (oz, oy, ox), w in taps:
                            r_ = (e + sy - yo + oy)[:, None]
                            c_ = (lanes + sx - xo + ox)[None, :]
                            bad = ~((r_ >= 0) & (r_ < ey) & (c_ >= 0) & (c_ < ew))
                            ri, ci = r_.clamp(0, ey - 1), c_.clamp(0, ew - 1)
                            v = ring[sl[oz + 1]][ri, ci]
                            o = ring_obs[sl[oz + 1]][ri, ci]
                            # the clamped cell of an obstacle
                            r2 = (ri + (torch.clamp(torch.clamp(sy + oy, max=Y - 2), min=1)
                                        - (sy + oy))[:, None]).clamp(0, ey - 1)
                            c2 = (ci + (torch.clamp(torch.clamp(sx + ox, max=X - 2), min=1)
                                        - (sx + ox))[None, :]).clamp(0, ew - 1)
                            v = torch.where(o == 1, ring[sc[oz + 1]][r2, c2], v)
                            bad = bad | torch.isnan(o) | (sl[oz + 1] in busy) | (
                                (o == 1) & (sc[oz + 1] in busy))
                            v = torch.where(bad, torch.full_like(v, nan), v)
                            tp = v * w
                            acc = tp if acc is None else acc + tp
                        H.append(acc * m)
                    H = torch.stack(H)
                    if emit == "h2":
                        h2 = None
                        for d, cst in enumerate(h_ext):
                            tot = H[d] + cst if cst else H[d]
                            h2 = tot * tot if h2 is None else h2 + tot * tot
                        H = h2[None]
                    lo = max(zs - 1, z0) if zs == zlo else zs
                    hi = min(zs + 1, z1 - 1) if zs == zhi else zs
                    yy = yo[:, None].expand_as(ok)[ok]
                    xx = xo[None, :].expand_as(ok)[ok]
                    for zw in range(lo, hi + 1):
                        out[:, zw, yy, xx] = H[:, ok]
                        writes[zw, yy, xx] += 1

                for r in range(n_ticks):
                    p = r - k + 1
                    store = k - 1 <= p < n_ticks - k + 1
                    if r - k - 1 >= k:
                        trail(r - k - 1, {p % slots} if store else set())
                    if store:
                        zp = z0 + p - k
                        v = psi_ext[zp + 1][rowy][:, colx]
                        ring[p % slots] = torch.where(
                            stage_k[:, None], torch.where(exact, v, torch.full_like(v, nan)),
                            ring[p % slots])
                        ring_obs[p % slots] = torch.where(
                            stage_k[:, None], obs_ext[zp + 1][rowy][:, colx].float(),
                            ring_obs[p % slots])
                trail(n_ticks - k - 1, set())
    return out, writes, h_writes


def test_trail_pass_loads_its_input_plane_once():
    """The trailing pass's EY warps (``threads``) load every (row, channel)
    of the input plane that stage 1 reads, rows -1..EY, each by one warp,
    and of the halo rows -1 and EY only those."""
    for k in range(1, pp.TRAIL_MAX_K + 1):
        ey = pp.TY + 2 * k
        assert pp.threads(k, pp.TY) == 32 * ey
        reads = {(e - EY_Q[q], q) for e in range(ey) for q in range(19)}
        loads = trail_loads(ey)
        assert reads <= set(loads)
        assert {key for key in loads if key[0] in (-1, ey)} == {
            key for key in reads if key[0] in (-1, ey)}
        assert set(loads.values()) == set(range(ey))


#: (grid, k, ty, lz): the grid's last column and row each alone past a tile
#: (X - 1 and Y - 1 multiples of the tile), chunks of 3 with a last of 2, a
#: 3-plane grid, one chunk, and tiles that divide nothing
REPLAYS = [
    ((8, 10, 25), 3, 9, 3),
    ((6, 19, 49), 2, 9, 4),
    ((8, 12, 30), 1, 9, 2),
    ((3, 3, 3), 3, 9, 3),
    ((9, 14, 41), 3, 9, 9),
]


def _replay_inputs(res, seed):
    Z, Y, X = res
    rng = np.random.default_rng(seed)
    psi = torch.from_numpy(rng.standard_normal(res).astype(np.float32))
    obs = torch.from_numpy(rng.uniform(size=res) < 0.3)
    obs[0], obs[-1], obs[:, :, 0], obs[:, :, -1] = True, True, True, True
    return psi, obs


@pytest.mark.parametrize("emit", ["hint", "h2"])
@pytest.mark.parametrize("res,k,ty,lz", REPLAYS)
def test_trail_schedule_equals_plain_bit_for_bit(res, k, ty, lz, emit):
    """One device: planes -1 and Z are the wrap; clamp (1, Z - 2)."""
    Z = res[0]
    assert lz == Z or (lz >= 2 and Z % lz != 1)  # trail_pass's chunk rule
    psi, obs = _replay_inputs(res, sum(res) + k)
    wrap = torch.arange(-1, Z + 1) % Z
    got, writes, h_writes = emulate_trail(psi[wrap], obs[wrap], k, ty, lz, (1, Z - 2), 0.5, emit,
                                          H_EXT)
    mf = torch.where(obs, OBS, FLUID).to(torch.uint8)[None, None]
    want = pp.trail_plain(psi[None, None], mf, dx=0.5, h_ext=H_EXT, emit=emit,
                          clamp=(1, Z - 2))
    assert torch.equal(writes, torch.ones_like(writes))
    assert torch.equal(h_writes, torch.ones_like(h_writes))
    assert torch.equal(got, want[0])


def _seam_obstacles(res, k, ty):
    """Magnetic obstacles on both z edge planes, on the x/y ring at and beside
    the trailing pass's tile seams (x = tx - 1, tx, 2 tx - 1, 2 tx; y = ty -
    1, ty) and at its corners, on every plane, so that the substitution reads
    across planes (planes 0 and Z - 1 from 1 and Z - 2) and across the tiles'
    edges; the rest fluid."""
    Z, Y, X = res
    tx = pp.tile_width(k + 1)
    obs = torch.zeros(res, dtype=torch.bool)
    obs[0], obs[-1] = True, True
    for x in (tx - 1, tx, 2 * tx - 1, 2 * tx, 0, X - 1):
        obs[:, 0, x % X], obs[:, Y - 1, x % X] = True, True
    for y in (ty - 1, ty, 0, Y - 1):
        obs[:, y % Y, 0], obs[:, y % Y, X - 1] = True, True
    return obs


@pytest.mark.parametrize("emit", ["hint", "h2"])
def test_trail_schedule_with_seam_obstacles(emit):
    """Obstacles only where the substitution changes a value (the z edge
    planes, the x/y ring beside the tile seams): one device, bit for bit
    to ``trail_plain``."""
    res, k, ty, lz = (8, 19, 49), 3, 9, 3
    Z = res[0]
    psi = _replay_inputs(res, 13)[0]
    obs = _seam_obstacles(res, k, ty)
    wrap = torch.arange(-1, Z + 1) % Z
    got, writes, _ = emulate_trail(psi[wrap], obs[wrap], k, ty, lz, (1, Z - 2), 0.5, emit, H_EXT)
    mf = torch.where(obs, OBS, FLUID).to(torch.uint8)[None, None]
    want = pp.trail_plain(psi[None, None], mf, dx=0.5, h_ext=H_EXT, emit=emit, clamp=(1, Z - 2))
    assert torch.equal(writes, torch.ones_like(writes))
    assert torch.equal(got, want[0])


@pytest.mark.parametrize("clamp", [(1, 8), (-1, 6), (-1, 8), (1, 6)],
                         ids=["bottom", "top", "inner", "both"])
def test_trail_slab_schedule_equals_plain_bit_for_bit(clamp):
    """A slab of 8 planes: psi of the planes either side (-1 and 8) from its
    bands, the clamp at the domain's true edges only."""
    Zl = 8
    psi, obs = _replay_inputs((Zl + 2, 11, 26), 7)
    got, writes, _ = emulate_trail(psi, obs, 3, 9, 3, clamp, 1.0, "h2", H_EXT)
    mf = torch.where(obs, OBS, FLUID).to(torch.uint8)[None, None]
    want = pp.trail_plain(psi[None, None], mf, dx=1.0, h_ext=H_EXT, emit="h2",
                          clamp=(clamp[0] + 1, clamp[1] + 1), out=(1, Zl + 1))
    assert torch.equal(writes, torch.ones_like(writes))
    assert torch.equal(got, want[0])
