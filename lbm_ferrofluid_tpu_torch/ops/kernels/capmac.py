"""B6: the HCZ capillary stage alone, gradients + force + macro recovery.

Replaces the TPU kernel ``lbm_ferrofluid_tpu/ops/pallas/capmac.py:
hcz_capillary_gradmac`` (:383) with ``lap=None``, as the single-device step
calls it: the Laplacian of density(rho_ca) is built inside.  The CUDA
source ``csrc/capmac.cu`` runs it as ``N_LAUNCHES`` = 1 launch, with no
scratch field in device memory: a block owns a tile of ``plan``'s
(tx, ty) and walks a strip of zb planes of z, with density(rho_ca) of the
tile and a 2-cell halo in a 4-plane shared-memory ring one plane ahead of
a 3-plane ring of the derived fields (lap, chi with ``H2``, fai, prho) of
the tile and a 1-cell halo, which the gradients tap.

Semantics kept (capmac.py:14-25): fai and prho come from the
pre-contact-angle fields, the Laplacian and the force from density(rho_ca);
only lap and chi are substituted at obstacles; z is clamped, not periodic;
the Laplacian has a zero ring; gradient outputs replicate the nearest
interior cell.  The plain version is ``ops/collide.py:hcz_capillary``.

Bound on an H100: bytes (see :func:`cost`), about 69 B per cell without
``H2`` and 77 B with it, plus 16 B per fluid cell (g_sum, g_mom) and 12 B
per other cell (vel_old).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ...utils.types import CellType
from ..collide import MU0, hcz_capillary
from ._lib import call, check_cuda, ptr, stream_of

__all__ = [
    "hcz_capillary_gradmac", "hcz_capillary_gradmac_plain", "cost", "plan", "CapPlan",
    "N_LAUNCHES", "TILES",
]

TPU_KERNEL = "lbm_ferrofluid_tpu/ops/pallas/capmac.py:383"
CUDA_SOURCE = "lbm_ferrofluid_tpu_torch/csrc/capmac.cu"
N_LAUNCHES = 1
#: (tx, ty) tiles the kernel is built for: ``CM_TILES`` of ``csrc/capmac.cu``
TILES = ((32, 8), (64, 4))
#: threads an SM the kernel's launch bounds ask room for: ``CM_SM_THREADS``
#: of ``csrc/capmac.cu`` (blocks resident on an SM = this / (tx ty))
SM_THREADS = 1280
#: the tile ``plan`` takes, the longest strip it considers, and a strip's
#: start-up (the derived and density planes it loads before its first cell
#: plane) in cell planes: from ``chip_smoke.py --capillary-plans``
TILE = (32, 8)
MAX_STRIP = 64
STRIP_START = 0.65


class CapPlan(NamedTuple):
    """A launch's (tx, ty) tile, one of ``TILES``, and its strip of zb
    planes."""

    tx: int
    ty: int
    zb: int


def plan(Z: int, Y: int, X: int, sms: int) -> CapPlan:
    """The tile and strip of a call on a Z x Y x X grid on a card of ``sms``
    SMs: the strip with the fewest waves of resident blocks times planes a
    block (its strip and start-up)."""
    tx, ty = TILE
    tiles = -(-X // tx) * -(-Y // ty)
    resident = sms * (SM_THREADS // (tx * ty))

    def ticks(zb):
        return -(-tiles * -(-Z // zb) // resident) * (zb + STRIP_START)

    return CapPlan(tx, ty, min(range(1, min(Z, MAX_STRIP) + 1), key=ticks))


def _read_masks(flags):
    """(interior, ring, corner) boolean masks of the grid of ``flags``."""
    Z, Y, X = flags.shape[-3:]
    interior = torch.zeros((Z, Y, X), dtype=torch.bool, device=flags.device)
    interior[1:-1, 1:-1, 1:-1] = True
    corner = torch.zeros_like(interior)
    corner[::Z - 1, ::Y - 1, ::X - 1] = True
    return interior, ~interior, corner


def cost(rho_pre, density_pre, pressure, rho_ca, H2, phi, flags, g_sum, g_mom,
         vel_old, **_) -> tuple[int, int]:
    """(bytes, flops) that a call on these inputs must move and do.

    Bytes: rho_pre and density_pre only at interior cells (fai and prho
    take their boundary ring from the interior); pressure at interior cells
    and at non-fluid ring cells (prho, and the pressure kept there);
    rho_ca, flags and H2 at every cell (the Laplacian reaches the ring, the
    force is emitted everywhere); phi at interior cells and at ring cells
    that are neither obstacles (substituted) nor box corners (the 19-point
    stencil has no corner taps); g_sum and g_mom only at fluid cells,
    vel_old only at the others; vel, pressure, force, dfai and dprho
    (13 channels) written.  Flops: ~16 per cell for fai, prho and the
    density map, 30 per interior cell for the Laplacian, 60 per cell for
    each of the 3 (or 4, with chi's ~10 more) gradient fields, 12 (18)
    for the force and ~24 per fluid cell for the recovery."""
    n = flags.numel()
    f = flags[0, 0]
    interior, ring, corner = _read_masks(flags)
    fluid = f == int(CellType.FLUID)
    obs = f == int(CellType.OBSTACLE)
    n_int, n_fluid = int(interior.sum()), int(fluid.sum())
    n_pres = n_int + int((ring & ~fluid).sum())
    nbytes = 4 * (2 * n_int + n_pres) + n * (4 + 1 + 13 * 4)
    nbytes += 16 * n_fluid + 12 * (n - n_fluid)
    flops = 16 * n + 30 * n_int + 180 * n + 12 * n + 24 * n_fluid
    if H2 is not None:
        n_phi = n_int + int((ring & ~obs & ~corner).sum())
        nbytes += 4 * n + 4 * n_phi
        flops += 70 * n
    return nbytes, flops


def hcz_capillary_gradmac_plain(rho_pre, density_pre, pressure, rho_ca, H2, phi, flags,
                                g_sum, g_mom, vel_old, *, kappa, gravity, rho_gas,
                                rho_fluid, density_gas, density_fluid, dx=1.0, dt=1.0):
    """Plain PyTorch version of :func:`hcz_capillary_gradmac`."""
    grav = torch.tensor(gravity, dtype=vel_old.dtype, device=vel_old.device)
    _, vel, _, pres, force, dfai, dprho = hcz_capillary(
        rho_pre, vel_old, flags, density_pre, pressure, rho_ca, H2, phi, g_sum, g_mom,
        kappa=kappa, gravity=grav.reshape(1, 3, 1, 1, 1), rho_gas=rho_gas,
        rho_fluid=rho_fluid, density_gas=density_gas, density_fluid=density_fluid,
        dx=dx, dt=dt,
    )
    return vel, pres, force, dfai, dprho


def hcz_capillary_gradmac(rho_pre, density_pre, pressure, rho_ca, H2, phi, flags, g_sum,
                          g_mom, vel_old, *, kappa, gravity, rho_gas, rho_fluid,
                          density_gas, density_fluid, dx=1.0, dt=1.0):
    """The capillary stage -> (vel, pressure, force, dfai, dprho).

    ``rho_pre``/``density_pre``/``pressure`` are this step's
    pre-contact-angle rho, density and old pressure, ``rho_ca`` the
    contact-angle-rewritten rho, ``H2``/``phi`` the Kelvin field and order
    parameter (both None: no Kelvin term), ``g_sum``/``g_mom`` the streamed
    moments of g, ``vel_old`` the velocity kept at non-fluid cells and
    ``gravity`` a 3-tuple; scalars are [1, 1, Z, Y, X] and vectors
    [1, 3, Z, Y, X] float32, flags uint8.  CPU tensors take the plain
    version; CUDA tensors launch the kernel; anything else raises.  Inputs
    are not modified."""
    kw = dict(kappa=kappa, gravity=gravity, rho_gas=rho_gas, rho_fluid=rho_fluid,
              density_gas=density_gas, density_fluid=density_fluid, dx=dx, dt=dt)
    if rho_pre.device.type == "cpu":
        return hcz_capillary_gradmac_plain(rho_pre, density_pre, pressure, rho_ca, H2, phi,
                                           flags, g_sum, g_mom, vel_old, **kw)
    if (H2 is None) != (phi is None):
        raise ValueError("hcz_capillary_gradmac: give H2 and phi together, or neither")
    B, C, Z, Y, X = rho_pre.shape
    scalar = (1, 1, Z, Y, X)
    named = [("rho_pre", rho_pre), ("density_pre", density_pre), ("pressure", pressure),
             ("rho_ca", rho_ca), ("g_sum", g_sum)]
    if H2 is not None:
        named += [("H2", H2), ("phi", phi)]
    for name, t in named:
        check_cuda(name, t, torch.float32, scalar)
    check_cuda("g_mom", g_mom, torch.float32, (1, 3, Z, Y, X))
    check_cuda("vel_old", vel_old, torch.float32, (1, 3, Z, Y, X))
    check_cuda("flags", flags, torch.uint8, scalar)
    if min(Z, Y, X) < 3:
        raise ValueError("hcz_capillary_gradmac needs Z, Y, X >= 3")
    dims = (ctypes.c_int(Z), ctypes.c_int(Y), ctypes.c_int(X))
    gas = tuple(ctypes.c_double(float(v))
                for v in (rho_gas, rho_fluid, density_gas, density_fluid))

    pl = plan(Z, Y, X, torch.cuda.get_device_properties(rho_pre.device).multi_processor_count)
    vel, pres = torch.empty_like(vel_old), torch.empty_like(pressure)
    force, dfai, dprho = (torch.empty_like(vel_old) for _ in range(3))
    call("lbm_capmac", ptr(flags), ptr(rho_pre), ptr(density_pre), ptr(pressure),
         ptr(rho_ca), ptr(phi), ptr(H2), ptr(g_sum), ptr(g_mom), ptr(vel_old), ptr(vel),
         ptr(pres), ptr(force), ptr(dfai), ptr(dprho), *dims, *(ctypes.c_int(v) for v in pl),
         ctypes.c_double(kappa), *(ctypes.c_double(float(v)) for v in gravity),
         ctypes.c_double(0.5 * MU0), ctypes.c_double(dx), ctypes.c_double(dt), *gas,
         stream_of(rho_pre))
    hcz_capillary_gradmac.launches += 1
    return vel, pres, force, dfai, dprho


hcz_capillary_gradmac.launches = 0
