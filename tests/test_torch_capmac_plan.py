"""B6's one-launch schedule, on the CPU.

The CUDA kernel (``csrc/capmac.cu:lbm_capmac``) runs the capillary stage as
one launch: a block owns a tx x ty tile of ``plan`` (one of ``TILES``) and
walks a strip of zb planes.  It keeps density(rho_ca) of the tile and a
2-cell halo in a 4-plane ring (slot q % 4), one plane ahead of a 3-plane
ring (slot p % 3) of the derived fields lap, chi (with H2), fai and prho of
the tile and a 1-cell halo, whose rows and columns start at
``lbm_ring_origin``; it builds a derived plane at load (fai and prho at the
nearest interior cell, lap and chi there at obstacles, lap zero on the
grid's boundary ring) and taps the ring around the nearest interior cell.
It cannot run here, so ``replay`` walks the same schedule in PyTorch:
every block, the same loads in the same order into rings that start as
NaN, the same slots and offsets.  A read of a slot, row, column or plane
the kernel would not have filled shows as NaN or as a wrong value.  The
replay in float64 must equal ``hcz_capillary_gradmac_plain`` to 1e-12.
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lbm_ferrofluid_tpu_torch.ops.collide import MU0, chi_of_phi  # noqa: E402
from lbm_ferrofluid_tpu_torch.ops.kernels import capmac  # noqa: E402
from lbm_ferrofluid_tpu_torch.ops.moments import (  # noqa: E402
    eos_pressure,
    phi_from_density,
    rho_to_density,
)

OBS, FLUID = 2, 1
RG, RF = 0.02381, 0.2508
GAS = dict(rho_gas=RG, rho_fluid=RF, density_gas=RG, density_fluid=RF)
KW = dict(kappa=0.1, gravity=(0.0, -1e-5, 2e-6), dx=1.0, dt=1.0, **GAS)
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


def replay(rho_pre, density_pre, pressure, rho_ca, H2, phi, flags, g_sum, g_mom, vel_old, pl,
           *, kappa, gravity, rho_gas, rho_fluid, density_gas, density_fluid, dx, dt):
    """B6 as ``lbm_capmac`` schedules it under the plan ``pl``."""
    Z, Y, X = flags.shape[2:]
    tx, ty, zb = pl
    has_chi = H2 is not None
    c = dx / dt
    RT = c * c / 3.0
    fl = flags[0, 0]
    dens_full = rho_to_density(rho_ca, rho_gas=rho_gas, rho_fluid=rho_fluid,
                               density_gas=density_gas, density_fluid=density_fluid)[0, 0]
    fai_full = (eos_pressure(rho_pre, dx=dx, dt=dt) - rho_pre * RT)[0, 0]
    prho_full = (pressure - RT * density_pre)[0, 0]
    chi_full = chi_of_phi(phi, dx)[0, 0] if has_chi else None
    nan = float("nan")
    vel, force, dfai, dprho = (torch.full_like(vel_old, nan) for _ in range(4))
    pres = torch.full_like(pressure, nan)
    for bz in range(-(-Z // zb)):
        for by in range(-(-Y // ty)):
            for bx in range(-(-X // tx)):
                x0, y0, z0 = bx * tx, by * ty, bz * zb
                z1 = min(z0 + zb, Z)
                rx0, ry0 = clamp(x0, 1, X - 2) - 1, clamp(y0, 1, Y - 2) - 1
                ring = torch.full((3, 4, ty + 2, tx + 2), nan, dtype=vel_old.dtype)
                dens = torch.full((4, ty + 4, tx + 4), nan, dtype=vel_old.dtype)
                # the rings' grid rows and columns, clamped to the grid
                gy = torch.clamp(ry0 + torch.arange(ty + 2), 0, Y - 1)[:, None]
                gx = torch.clamp(rx0 + torch.arange(tx + 2), 0, X - 1)[None, :]
                dy = torch.clamp(ry0 - 1 + torch.arange(ty + 4), 0, Y - 1)[:, None]
                dxs = torch.clamp(rx0 - 1 + torch.arange(tx + 4), 0, X - 1)[None, :]
                cy, cx = torch.clamp(gy, 1, Y - 2), torch.clamp(gx, 1, X - 2)

                def load_density(q):
                    dens[q % 4] = dens_full[q, dy, dxs]

                def derive(p):
                    pc = clamp(p, 1, Z - 2)
                    obs = fl[p, gy, gx] == OBS
                    mz = torch.where(obs, pc, p)
                    my, mx = torch.where(obs, cy, gy), torch.where(obs, cx, gx)
                    inner = ((mz >= 1) & (mz <= Z - 2) & (my >= 1) & (my <= Y - 2)
                             & (mx >= 1) & (mx <= X - 2))
                    # density-ring rows and columns of m, kept in range where
                    # the Laplacian is not taken
                    ly = torch.clamp(my - ry0 + 1, 1, ty + 2)
                    lx = torch.clamp(mx - rx0 + 1, 1, tx + 2)
                    lz = torch.clamp(mz, 1, Z - 2)

                    def S(oz, oy, ox):
                        return dens[(lz + oz) % 4, ly + oy, lx + ox]

                    lap = laplacian(S, dx)
                    assert not torch.isnan(lap[inner]).any(), f"density ring read at {p}"
                    ring[p % 3, 0] = torch.where(inner, lap, 0.0)
                    if has_chi:
                        ring[p % 3, 1] = chi_full[mz, my, mx]
                    ring[p % 3, 2] = fai_full[pc, cy, cx]
                    ring[p % 3, 3] = prho_full[pc, cy, cx]

                hi_last = clamp(z1 - 1, 1, Z - 2) + 1
                dmax = clamp(hi_last, 1, Z - 2) + 1
                hi = clamp(z0, 1, Z - 2) + 1
                dhi = clamp(hi - 2, 1, Z - 2) - 2

                def advance(p, dhi):
                    pc = clamp(p, 1, Z - 2)
                    while dhi < pc + 1:
                        dhi += 1
                        load_density(dhi)
                    if dhi == pc + 1 and dhi < dmax:
                        dhi += 1
                        load_density(dhi)
                    derive(p)
                    return dhi

                for p in range(hi - 2, hi + 1):
                    dhi = advance(p, dhi)
                xs = torch.arange(x0, min(x0 + tx, X))
                ys = torch.arange(y0, min(y0 + ty, Y))
                xl = (torch.clamp(xs, 1, X - 2) - rx0)[None, :]
                yl = (torch.clamp(ys, 1, Y - 2) - ry0)[:, None]
                for z in range(z0, z1):
                    zc = clamp(z, 1, Z - 2)
                    if zc + 1 > hi:
                        hi += 1
                        dhi = advance(hi, dhi)
                    slots = {-1: (zc - 1) % 3, 0: zc % 3, 1: (zc + 1) % 3}

                    def grad(f):
                        g = iso_sums(lambda oz, oy, ox: ring[slots[oz], f, yl + oy, xl + ox])
                        return [v * (1.0 / (12.0 * dx)) for v in g]

                    glap, gfai, gprho = grad(0), grad(2), grad(3)
                    gchi = grad(1) if has_chi else None
                    cell = (slice(None), slice(None), z, ys[:, None], xs[None, :])
                    rho = rho_ca[cell][0, 0]
                    den = rho_to_density(rho, rho_gas=rho_gas, rho_fluid=rho_fluid,
                                         density_gas=density_gas, density_fluid=density_fluid)
                    fluid = fl[z, ys[:, None], xs[None, :]] == FLUID
                    u = []
                    for d in range(3):
                        fd = kappa * den * glap[d] + gravity[d] * den
                        if has_chi:
                            fd = fd - 0.5 * MU0 * H2[cell][0, 0] * gchi[d]
                        ud = (g_mom[cell][0, d] * c + 0.5 * dt * RT * fd) / RT / den
                        u.append(torch.where(fluid, ud, vel_old[cell][0, d]))
                        force[0, d, z, ys[:, None], xs[None, :]] = fd
                        vel[0, d, z, ys[:, None], xs[None, :]] = u[d]
                        dfai[0, d, z, ys[:, None], xs[None, :]] = gfai[d]
                        dprho[0, d, z, ys[:, None], xs[None, :]] = gprho[d]
                    pr = g_sum[cell][0, 0] - 0.5 * dt * (u[0] * gprho[0] + u[1] * gprho[1]
                                                         + u[2] * gprho[2])
                    pres[0, 0, z, ys[:, None], xs[None, :]] = torch.where(
                        fluid, pr, pressure[cell][0, 0])
    return vel, pres, force, dfai, dprho


def seeded(res, seed, pl):
    """float64 inputs: an obstacle frame with holes, random interior
    obstacles, and a block across the plan's first tile edge in x and y and
    its first z strip seam."""
    rng = np.random.default_rng(seed)
    Z, Y, X = res
    fl = np.where(rng.uniform(size=(1, 1, *res)) < 0.1, OBS, FLUID).astype(np.uint8)
    ring = np.ones(res, bool)
    ring[1:-1, 1:-1, 1:-1] = False
    fl[0, 0][ring & (rng.uniform(size=res) < 0.8)] = OBS
    fl[..., max(pl.zb - 1, 1):pl.zb + 1, pl.ty - 1:pl.ty + 1, pl.tx - 1:pl.tx + 1] = OBS
    rho = RG + (RF - RG) * rng.uniform(size=(1, 1, *res))

    def T(a):
        return torch.from_numpy(np.asarray(a, np.float64))

    den = rho_to_density(T(rho), **GAS)
    return dict(
        rho_pre=T(rho), density_pre=den, pressure=T(rng.uniform(0.01, 0.03, (1, 1, *res))),
        rho_ca=T(rho + 1e-3 * rng.standard_normal((1, 1, *res))),
        H2=T(1e4 * rng.uniform(0.9, 1.1, (1, 1, *res))),
        phi=phi_from_density(den, RG, RF), flags=torch.from_numpy(fl),
        g_sum=T(rng.uniform(0.01, 0.03, (1, 1, *res))),
        g_mom=T(rng.uniform(-1e-3, 1e-3, (1, 3, *res))),
        vel_old=T(rng.uniform(-0.02, 0.02, (1, 3, *res))))


#: (grid, tile, strip): None takes ``plan``'s tile or strip.  Tiles that
#: divide nothing, a last tile holding only the last cell (65 = 2 x 32 + 1,
#: 129 = 2 x 64 + 1, and y rows 9 = 8 + 1 or 4 + 1), 130 = 4 x 32 + 2, strips that
#: end at Z - 1 and strips of one plane, Z = 4 and Z = 3, and
#: 34x66x130 and 50x50x193 scaled down (18x10x66, 10x10x65)
CASES = [
    ((4, 10, 65), None, None),
    ((18, 10, 66), None, None),
    ((10, 10, 65), None, 3),
    ((5, 8, 130), None, 2),
    ((7, 17, 70), (64, 4), 4),
    ((9, 12, 130), (64, 4), 2),
    ((6, 9, 129), (64, 4), 5),
    ((3, 5, 34), None, 1),
]


@pytest.mark.parametrize("kelvin", [False, True], ids=["without_h2", "with_h2"])
@pytest.mark.parametrize("res,tile,zb", CASES)
def test_schedule_equals_plain(res, tile, zb, kelvin):
    chosen = capmac.plan(*res, SMS)
    pl = capmac.CapPlan(*(tile or chosen[:2]), zb or chosen.zb)
    assert (pl.tx, pl.ty) in capmac.TILES
    d = seeded(res, sum(res), pl)
    if not kelvin:
        d["H2"] = d["phi"] = None
    args = [d[k] for k in ("rho_pre", "density_pre", "pressure", "rho_ca", "H2", "phi", "flags",
                           "g_sum", "g_mom", "vel_old")]
    got = replay(*args, pl, **KW)
    want = capmac.hcz_capillary_gradmac_plain(*args, **KW)
    for name, a, b in zip(("vel", "pressure", "force", "dfai", "dprho"), got, want, strict=True):
        assert not torch.isnan(a).any(), f"{name}: a cell was never written"
        err = float((a - b).abs().max() / b.abs().max())
        assert err <= 1e-12, f"{name}: {err:.2e}"


def test_kernel_tiles_are_the_cuda_sources():
    """TILES is CM_TILES of csrc/capmac.cu, which instantiates the kernel,
    and SM_THREADS its launch bounds' CM_SM_THREADS."""
    src = (Path(capmac.__file__).parents[2] / "csrc" / "capmac.cu").read_text()
    line = re.search(r"#define CM_TILES\(M\) (.*)", src)[1]
    tiles = tuple((int(a), int(b)) for a, b in re.findall(r"M\((\d+), (\d+)\)", line))
    assert tiles == capmac.TILES and capmac.TILE in tiles
    assert int(re.search(r"#define CM_SM_THREADS (\d+)", src)[1]) == capmac.SM_THREADS
    # static shared memory: the derived ring with chi and the density ring
    for tx, ty in tiles:
        assert 4 * (3 * 4 * (ty + 2) * (tx + 2) + 4 * (ty + 4) * (tx + 4)) <= 48 * 1024
        assert tx % 32 == 0 and tx * ty <= capmac.SM_THREADS


@pytest.mark.parametrize("res", [(256, 256, 256), (130, 130, 130), (130, 66, 130),
                                 (34, 66, 130), (50, 50, 193), (4, 8, 16), (3, 8, 16)])
def test_plan_is_a_built_tile_and_covers_the_grid(res):
    Z, Y, X = res
    pl = capmac.plan(Z, Y, X, SMS)
    assert (pl.tx, pl.ty) == capmac.TILE and capmac.N_LAUNCHES == 1
    assert 1 <= pl.zb <= min(Z, capmac.MAX_STRIP)


def test_plan_fills_the_waves_of_resident_blocks():
    """The strips the card was timed at (--capillary-plans): at 256^3 the
    256 tiles of 32 x 8, 5 blocks an SM on 132 SMs, take 52-plane strips
    (1280 blocks: 1.94 waves), not 16-plane ones (7.8 waves) or 64-plane
    ones (1024 blocks: 1.55 waves); at 130^3 the 85 tiles take 9-plane
    strips (1275 blocks)."""
    assert capmac.plan(256, 256, 256, SMS).zb == 52
    assert capmac.plan(130, 130, 130, SMS).zb == 9
    # a card of half the SMs takes strips that fill its own waves
    assert capmac.plan(256, 256, 256, SMS // 2).zb == 29
