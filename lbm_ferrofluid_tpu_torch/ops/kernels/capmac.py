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
per other cell (vel_old).  A batch ``[B, ...]`` is one launch (the batch
folded into the grid's z, the plan an element's), each element's bits
those of a call on it alone; the slab form takes one element.

The slab form (``lap=``, ``ghosts=``, ``clamp=``: the TPU kernel's slab
mode, for a z-slab of a domain decomposed along z over ranks,
``parallel/step3d.py``) takes the Laplacian of density(rho_ca) as an
input, as the TPU's slab mode does (B10b's slab form computes it), the
neighbours' edge planes ``ghosts = (lo, hi)``, each a [1, 5 | 6, 1, Y, X]
float32 bundle of lap, rho_pre, density_pre, pressure, flags (as float)
and, with ``H2``, phi (:func:`slab_bundle`, ``SLAB_PLANES``), and the z
clamp ``clamp = (zlo, zhi)``: 1 and Z-2 at the domain's true edges, -1 and
Z where the slab has a neighbour; slabs of 4 or more planes.  One launch
(``launches_slab``); its plain version is the capillary stage on the
slab extended by two planes on each side with a neighbour (its ghost
plane, repeated outside), as B3's slab form extends it.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ...utils.types import CellType
from ..collide import MU0, hcz_capillary
from ._lib import (call, check_batch, check_cuda, check_no_grad, check_slab_clamp, count_launch,
                   ptr, stream_of)
from .capillogue import cap_extend

__all__ = [
    "hcz_capillary_gradmac", "hcz_capillary_gradmac_plain", "cost", "cost_slab", "plan",
    "CapPlan", "N_LAUNCHES", "TILES", "SLAB_PLANES", "slab_bundle",
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


def _read_masks(flags, clamp=None):
    """(interior, ring, corner) boolean masks of the grid of ``flags``; with
    a slab's ``clamp``, the planes of a side with a neighbour count as
    interior."""
    Z, Y, X = flags.shape[-3:]
    z0, z1 = (1, Z - 1) if clamp is None else (max(clamp[0], 0), min(clamp[1] + 1, Z))
    interior = torch.zeros((Z, Y, X), dtype=torch.bool, device=flags.device)
    interior[z0:z1, 1:-1, 1:-1] = True
    corner = torch.zeros_like(interior)
    corner[[z for z in (0, Z - 1) if not z0 <= z < z1], ::Y - 1, ::X - 1] = True
    return interior, ~interior, corner


def cost(rho_pre, density_pre, pressure, rho_ca, H2, phi, flags, g_sum, g_mom,
         vel_old, clamp=None, **_) -> tuple[int, int]:
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
    for the force and ~24 per fluid cell for the recovery.  Each of the B
    elements of a batch counts."""
    n = flags.numel()
    f = flags[:, 0]
    interior, ring, corner = _read_masks(flags, clamp)
    fluid = f == int(CellType.FLUID)
    obs = f == int(CellType.OBSTACLE)
    n_int, n_fluid = int(interior.sum()) * flags.shape[0], int(fluid.sum())
    n_pres = n_int + int((ring & ~fluid).sum())
    nbytes = 4 * (2 * n_int + n_pres) + n * (4 + 1 + 13 * 4)
    nbytes += 16 * n_fluid + 12 * (n - n_fluid)
    flops = 16 * n + 30 * n_int + 180 * n + 12 * n + 24 * n_fluid
    if H2 is not None:
        n_phi = n_int + int((ring & ~obs & ~corner).sum())
        nbytes += 4 * n + 4 * n_phi
        flops += 70 * n
    return nbytes, flops


#: the planes of a slab form's ghost bundle, in order (phi only with H2)
SLAB_PLANES = ("lap", "rho_pre", "density_pre", "pressure", "flags", "phi")


def slab_bundle(lap, rho_pre, density_pre, pressure, flags, phi, side):
    """The [1, 5 | 6, 1, Y, X] float32 bundle of a slab's edge planes that its
    neighbour on ``side`` needs ("lo": the rank below, which takes the
    slab's top plane; "hi": the rank above, its bottom plane): lap,
    rho_pre, density_pre, pressure, flags (as float) and phi (where not
    None), ``SLAB_PLANES``' order."""
    j = slice(-1, None) if side == "lo" else slice(0, 1)
    fields = [lap, rho_pre, density_pre, pressure, flags.to(torch.float32)]
    fields += [] if phi is None else [phi]
    return torch.cat([x[:, :, j] for x in fields], dim=1)


def cost_slab(rho_pre, density_pre, pressure, rho_ca, H2, phi, flags, g_sum, g_mom, vel_old,
              lap=None, ghosts=None, clamp=None, **_) -> tuple[int, int]:
    """:func:`cost` of the slab form on its slab (the planes of a side with a
    neighbour counted as interior): lap read at every cell and the ghost
    bundles once more, no Laplacian's flops."""
    nbytes, flops = cost(rho_pre, density_pre, pressure, rho_ca, H2, phi, flags, g_sum,
                         g_mom, vel_old, clamp)
    n_int = int(_read_masks(flags, clamp)[0].sum()) * flags.shape[0]
    return (nbytes + 4 * flags.numel() + sum(t.numel() * 4 for t in ghosts),
            flops - 30 * n_int)


def _capmac_slab_plain(rho_pre, density_pre, pressure, rho_ca, H2, phi, flags, g_sum, g_mom,
                       vel_old, lap, ghosts, clamp, **kw):
    """The plain slab form: ``hcz_capillary`` with the given ``lap`` on the
    slab extended by two planes on each side with a neighbour (its ghost
    plane, and that plane again outside, which no kept plane reads);
    fields read only at the cell itself extend by repeats."""
    lo, hi = ghosts

    def ext(x, name=None):
        if x is None:
            return None
        if name is None:
            return cap_extend(x, None, None, clamp)
        j = SLAB_PLANES.index(name)
        return cap_extend(x, lo[:, j:j + 1], hi[:, j:j + 1], clamp)

    out = hcz_capillary(
        ext(rho_pre, "rho_pre"), ext(vel_old), ext(flags.to(torch.float32), "flags").to(
            flags.dtype), ext(density_pre, "density_pre"), ext(pressure, "pressure"),
        ext(rho_ca), ext(H2), ext(phi, "phi"), ext(g_sum), ext(g_mom), lap=ext(lap, "lap"),
        **kw)
    start = 2 if clamp[0] < 0 else 0
    Z = flags.shape[2]
    return tuple(x[:, :, start:start + Z] for x in out)


def hcz_capillary_gradmac_plain(rho_pre, density_pre, pressure, rho_ca, H2, phi, flags,
                                g_sum, g_mom, vel_old, lap=None, ghosts=None, clamp=None, *,
                                kappa, gravity, rho_gas, rho_fluid, density_gas,
                                density_fluid, dx=1.0, dt=1.0):
    """Plain PyTorch version of :func:`hcz_capillary_gradmac`."""
    grav = torch.tensor(gravity, dtype=vel_old.dtype, device=vel_old.device)
    kw = dict(kappa=kappa, gravity=grav.reshape(1, 3, 1, 1, 1), rho_gas=rho_gas,
              rho_fluid=rho_fluid, density_gas=density_gas, density_fluid=density_fluid,
              dx=dx, dt=dt)
    if ghosts is None:
        out = hcz_capillary(rho_pre, vel_old, flags, density_pre, pressure, rho_ca, H2, phi,
                            g_sum, g_mom, lap=lap, **kw)
    else:
        out = _capmac_slab_plain(rho_pre, density_pre, pressure, rho_ca, H2, phi, flags, g_sum,
                                 g_mom, vel_old, lap, ghosts, clamp, **kw)
    _, vel, _, pres, force, dfai, dprho = out
    return vel, pres, force, dfai, dprho


def hcz_capillary_gradmac(rho_pre, density_pre, pressure, rho_ca, H2, phi, flags, g_sum,
                          g_mom, vel_old, lap=None, ghosts=None, clamp=None, *, kappa,
                          gravity, rho_gas, rho_fluid, density_gas, density_fluid, dx=1.0,
                          dt=1.0):
    """The capillary stage -> (vel, pressure, force, dfai, dprho).

    ``rho_pre``/``density_pre``/``pressure`` are this step's
    pre-contact-angle rho, density and old pressure, ``rho_ca`` the
    contact-angle-rewritten rho, ``H2``/``phi`` the Kelvin field and order
    parameter (both None: no Kelvin term), ``g_sum``/``g_mom`` the streamed
    moments of g, ``vel_old`` the velocity kept at non-fluid cells and
    ``gravity`` a 3-tuple; scalars are [B, 1, Z, Y, X] and vectors
    [B, 3, Z, Y, X] float32, flags uint8, the B elements in one launch (the
    plan's tile and strip are an element's).  ``lap``, ``ghosts`` and
    ``clamp`` together give the slab form (module docstring, B = 1); the
    single-device kernel builds the Laplacian itself.  CPU tensors take the
    plain version; CUDA tensors launch the kernel; anything else raises.
    Inputs are not modified."""
    kw = dict(kappa=kappa, gravity=gravity, rho_gas=rho_gas, rho_fluid=rho_fluid,
              density_gas=density_gas, density_fluid=density_fluid, dx=dx, dt=dt)
    slab = ghosts is not None
    if {slab} != {lap is not None, clamp is not None}:
        raise ValueError("hcz_capillary_gradmac: give lap, ghosts and clamp together (the "
                         "slab form), or none of them")
    if rho_pre.device.type == "cpu":
        return hcz_capillary_gradmac_plain(rho_pre, density_pre, pressure, rho_ca, H2, phi,
                                           flags, g_sum, g_mom, vel_old, lap, ghosts, clamp,
                                           **kw)
    check_no_grad("hcz_capillary_gradmac", rho_pre, density_pre, pressure, rho_ca, H2, phi,
                  g_sum, g_mom, vel_old, lap)
    if (H2 is None) != (phi is None):
        raise ValueError("hcz_capillary_gradmac: give H2 and phi together, or neither")
    B, C, Z, Y, X = rho_pre.shape
    scalar = (B, 1, Z, Y, X)
    named = [("rho_pre", rho_pre), ("density_pre", density_pre), ("pressure", pressure),
             ("rho_ca", rho_ca), ("g_sum", g_sum)]
    if H2 is not None:
        named += [("H2", H2), ("phi", phi)]
    for name, t in named:
        check_cuda(name, t, torch.float32, scalar)
    check_cuda("g_mom", g_mom, torch.float32, (B, 3, Z, Y, X))
    check_cuda("vel_old", vel_old, torch.float32, (B, 3, Z, Y, X))
    check_cuda("flags", flags, torch.uint8, scalar)
    if min(Z, Y, X) < 3:
        raise ValueError("hcz_capillary_gradmac needs Z, Y, X >= 3")
    if slab:
        check_cuda("lap", lap, torch.float32, scalar)
        n_planes = len(SLAB_PLANES) - (H2 is None)
        for name, t in zip(("ghosts lo", "ghosts hi"), ghosts, strict=True):
            check_cuda(name, t, torch.float32, (1, n_planes, 1, Y, X))
        check_slab_clamp("hcz_capillary_gradmac", clamp, Z, hcz_capillary_gradmac.min_planes)
    dims = (ctypes.c_int(Z), ctypes.c_int(Y), ctypes.c_int(X))
    gas = tuple(ctypes.c_double(float(v))
                for v in (rho_gas, rho_fluid, density_gas, density_fluid))

    pl = plan(Z, Y, X, torch.cuda.get_device_properties(rho_pre.device).multi_processor_count)
    check_batch("hcz_capillary_gradmac", B, slab, -(-Z // pl.zb))
    vel, pres = torch.empty_like(vel_old), torch.empty_like(pressure)
    force, dfai, dprho = (torch.empty_like(vel_old) for _ in range(3))
    consts = (*(ctypes.c_int(v) for v in pl), ctypes.c_double(kappa),
              *(ctypes.c_double(float(v)) for v in gravity), ctypes.c_double(0.5 * MU0),
              ctypes.c_double(dx), ctypes.c_double(dt), *gas)
    if not slab:
        call("lbm_capmac", ptr(flags), ptr(rho_pre), ptr(density_pre), ptr(pressure),
             ptr(rho_ca), ptr(phi), ptr(H2), ptr(g_sum), ptr(g_mom), ptr(vel_old), ptr(vel),
             ptr(pres), ptr(force), ptr(dfai), ptr(dprho), ctypes.c_int(B), *dims, *consts,
             stream_of(rho_pre))
        count_launch(hcz_capillary_gradmac, False, None, B)
        return vel, pres, force, dfai, dprho
    lo, hi = ghosts
    planes = [(lo[:, j], hi[:, j]) for j in range(4)]
    planes.append((lo[:, 5], hi[:, 5]) if H2 is not None else (None, None))
    fl_lo, fl_hi = (b[:, SLAB_PLANES.index("flags")].to(torch.uint8) for b in ghosts)
    call("lbm_capmac_slab", ptr(flags), ptr(lap), ptr(rho_pre), ptr(density_pre),
         ptr(pressure), ptr(rho_ca), ptr(phi), ptr(H2), ptr(g_sum), ptr(g_mom), ptr(vel_old),
         ptr(vel), ptr(pres), ptr(force), ptr(dfai), ptr(dprho), *dims, *consts,
         *(ptr(t) for pair in planes for t in pair), ptr(fl_lo), ptr(fl_hi),
         *(ctypes.c_int(v) for v in clamp), stream_of(rho_pre))
    count_launch(hcz_capillary_gradmac, False, "slab")
    return vel, pres, force, dfai, dprho


hcz_capillary_gradmac.launches = 0
hcz_capillary_gradmac.launches_bf16 = 0
hcz_capillary_gradmac.launches_slab = 0
hcz_capillary_gradmac.launches_batch = 0
#: planes a slab of the slab form needs at least (the TPU kernel's 5-slot
#: ring: planes -1 to 2 in flight at its preamble)
hcz_capillary_gradmac.min_planes = 4
