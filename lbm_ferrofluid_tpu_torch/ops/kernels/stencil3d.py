"""B10a and B10b: the capillary stencils, and the capillary stage's stencil
route built from them.

B10a replaces the TPU kernel ``lbm_ferrofluid_tpu/ops/pallas/stencil3d.py:
grad_fields`` (:176) in its single-device form: 19-point isotropic
gradients of N stacked fields, with the TPU kernel's boundary-ring rule
(output ring replicated from the interior, x edges first, then y, then z),
which is the gradient evaluated around the nearest interior cell.  The
channel-form magnetic solve uses it on the obstacle-substituted psi
(``ops/magnetic.py:solve_H_int``).

B10b replaces ``laplacian_field`` (:242): the 19-point Laplacian with a zero
boundary ring (x/y edges everywhere, whole z edge planes).  The plain
version is ``ops/stencils.py:isotropic_laplacian``.

Both run one kernel template of ``csrc/stencil3d.cu``: a block owns a tile
of ``plan``'s (tx, ty) and walks a strip of zb planes of z, with each
field's plane of the tile and a 1-cell halo in a 4-plane shared-memory
ring, loaded a plane ahead.  B10b is one launch a call; B10a one launch
for each chunk of at most ``MAX_FIELDS`` fields (``launches_per_call``).
:func:`hcz_capillary_stencils` is the capillary stage as the JAX package's
``hcz_capillary`` runs it where its fused kernel (B6) cannot: B10b, the
obstacle substitution, one B10a call on the stacked fields, and the force
and macro recovery in PyTorch.

Bounds on an H100 (card peaks from NVIDIA's data sheet): bytes.  B10a 16 B
per cell and field, 0.080 ms at 256^3 for one field over 3.35 TB/s; B10b
8 B per cell, 0.040 ms at 256^3.

B10b's slab form (``ghosts=``, ``clamp=``: the TPU kernel's ghost_lo and
ghost_hi, for a z-slab of a domain decomposed along z over ranks,
``parallel/step3d.py``) takes the neighbours' edge planes ``ghosts = (lo,
hi)``, [1, 1, 1, Y, X] each, as planes -1 and Z, and the z clamp ``clamp =
(zlo, zhi)``: 1 and Z-2 at the domain's true edges (their planes take the
zero ring), -1 and Z where the slab has a neighbour.  One launch
(``launches_slab``); its plain version is the Laplacian of the slab
extended by the ghost planes, with the true edges' planes zeroed.  Either
form takes rho with ``density_of = (rho_gas, rho_fluid, density_gas,
density_fluid)`` and maps each value as it loads it: the Laplacian of
density(rho_ca) as B6's single-device kernel builds it, so that the z-slab
route's (B6's slab form takes it as an input) equals the single-device
route's bit for bit; the plain version maps with
``ops/moments.py:rho_to_density``.

B10a takes a batch ``[B, N, Z, Y, X]`` (the block route's psi route at
more than one element a rank, ``parallel/step3d.py:channel_poisson_blocks``)
as the B * N fields of one element: the kernel computes each field on its
own and the wrapper writes field f's three components at channels 3f..3f+2,
so the contiguous batch is viewed as ``[1, BN, ...]`` and the output
``[1, 3BN, ...]`` as ``[B, 3N, ...]``, each element's bits those of a call
on it alone (no CUDA change); ``launches_batch`` counts its launches at
B > 1, one a chunk of ``MAX_FIELDS`` fields.  B10b takes one element.

B10a's slab form (``ghosts=``, ``clamp=``: the TPU kernel's ghost_lo and
ghost_hi with its caller's fix, ``parallel/step3d.py:grad_fields_sharded``)
takes each field's neighbour planes, ``ghosts = (lo, hi)`` [B, N, 1, Y, X]
each, and the same z clamp: the output ring is replicated in x and y on
every slab and in z only at the domain's true edges (``launches_slab``,
one a chunk of fields); its plain version is :func:`grad_fields_plain` of
the slab extended by the ghost planes, with the true edges' planes
replicated from their neighbours.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..collide import MU0, capillary_potentials, chi_of_phi, recover_macros
from ..moments import rho_to_density
from ..stencils import grad_ring_replicate, isotropic_laplacian, substitute_obstacles
from ._lib import (call, check_batch, check_cuda, check_no_grad, check_slab_clamp,
                   check_unbatched, count_launch, ptr, stream_of)

__all__ = [
    "grad_fields", "grad_fields_plain", "cost", "laplacian_field", "laplacian_field_plain",
    "cost_laplacian", "cost_laplacian_slab", "cost_slab", "capillary_stack", "hcz_capillary_stencils", "plan", "StencilPlan", "chunks",
    "launches_per_call", "TILES", "fits",
]

TPU_KERNEL = "lbm_ferrofluid_tpu/ops/pallas/stencil3d.py:176"
TPU_KERNEL_LAPLACIAN = "lbm_ferrofluid_tpu/ops/pallas/stencil3d.py:242"
CUDA_SOURCE = "lbm_ferrofluid_tpu_torch/csrc/stencil3d.cu"
#: (tx, ty, ry) tiles the kernel is built for, ry rows a thread: ``ST_TILES``
#: of ``csrc/stencil3d.cu``; an instance is built where its ring fits in
#: ``SMEM_MAX`` bytes of static shared memory (``fits``)
TILES = ((32, 8, 1), (64, 8, 2), (64, 16, 4))
SMEM_MAX = 49152
#: fields one launch of B10a takes at most: ``ST_MAX_FIELDS``
MAX_FIELDS = 4
#: shared memory an SM gives its blocks, and what each block reserves
#: besides its own, on an H100
SMEM_SM, SMEM_RESERVED = 233472, 1024
#: the tile ``plan`` takes and the longest strip it considers, for the
#: Laplacian (key 0) and for the gradients of 1..``MAX_FIELDS`` fields, and
#: a strip's start-up (the planes it loads before its first cell plane) in
#: cell planes: from ``chip_smoke.py --stencil-plans``
SHAPES = {0: ((64, 16), 8), 1: ((64, 8), 8), 2: ((64, 8), 8), 3: ((64, 8), 4),
          4: ((32, 8), 4)}
STRIP_START = 1.0


class StencilPlan(NamedTuple):
    """A launch's (tx, ty) tile, one of ``TILES``, and its strip of zb
    planes."""

    tx: int
    ty: int
    zb: int


def min_blocks(n_fields: int, laplacian: bool = False) -> int:
    """Blocks an SM the launch bounds ask room for, for the Laplacian or
    the gradients of ``n_fields`` fields: ``ST_MIN_BLOCKS`` of
    ``csrc/stencil3d.cu``."""
    return 6 if laplacian else 8 if n_fields <= 2 else 5


def smem_bytes(tx: int, ty: int, n_fields: int) -> int:
    """Static shared memory of a block: 4 ring planes of the tile and its
    1-cell halo for each field."""
    return 4 * 4 * n_fields * (ty + 2) * (tx + 2)


def fits(tx: int, ty: int, n_fields: int) -> bool:
    """Whether the (tx, ty) instance for ``n_fields`` fields is built."""
    return smem_bytes(tx, ty, n_fields) <= SMEM_MAX


def blocks_per_sm(tx: int, ty: int, n_fields: int, laplacian: bool = False) -> int:
    """Resident blocks an SM: the launch bounds' room, or what shared
    memory holds if that is less."""
    return min(min_blocks(n_fields, laplacian),
               SMEM_SM // (smem_bytes(tx, ty, n_fields) + SMEM_RESERVED))


@functools.lru_cache(maxsize=None)
def plan(Z: int, Y: int, X: int, sms: int, n_fields: int = 1,
         laplacian: bool = False) -> StencilPlan:
    """The tile and strip of a launch on a Z x Y x X grid with ``n_fields``
    fields (``laplacian``: B10b) on a card of ``sms`` SMs: ``SHAPES``'s
    tile, and the strip up to its longest with the fewest waves of
    resident blocks times planes a block (its strip and start-up).
    Cached: a wrapper asks for it at every call."""
    (tx, ty), longest = SHAPES[0 if laplacian else n_fields]
    tiles = -(-X // tx) * -(-Y // ty)
    resident = sms * blocks_per_sm(tx, ty, 1 if laplacian else n_fields, laplacian)

    def ticks(zb):
        return -(-tiles * -(-Z // zb) // resident) * (zb + STRIP_START)

    return StencilPlan(tx, ty, min(range(1, min(Z, longest) + 1), key=ticks))


def chunks(n_fields: int) -> list[int]:
    """Fields each of B10a's launches takes for ``n_fields`` fields."""
    return [MAX_FIELDS] * (n_fields // MAX_FIELDS) + (
        [n_fields % MAX_FIELDS] if n_fields % MAX_FIELDS else [])


def launches_per_call(n_fields: int) -> int:
    """B10a's launches for ``n_fields`` fields (B * N of a batch of B
    elements of N fields): one a chunk."""
    return len(chunks(n_fields))


def cost(fields, **_) -> tuple[int, int]:
    """(bytes, flops) that a call on these inputs must move and do: each
    field of each batch element read once and its three components written
    once (16 B per cell and field); 33 flops per interior cell and field
    (the ring copies the interior)."""
    B, n_fields, Z, Y, X = fields.shape
    n_fields *= B
    n = Z * Y * X
    return 16 * n_fields * n, 33 * n_fields * (Z - 2) * (Y - 2) * (X - 2)


def cost_slab(fields, ghosts=None, clamp=None, **_) -> tuple[int, int]:
    """:func:`cost` of the slab form: the two ghost planes of each field
    read once more; the stencil at the planes that ``clamp`` computes (a
    true edge's plane copies its neighbour's)."""
    B, n_fields, Z, Y, X = fields.shape
    n_fields *= B
    planes = Z - (clamp[0] > 0) - (clamp[1] < Z)
    return 16 * n_fields * Z * Y * X + 8 * n_fields * Y * X, 33 * n_fields * planes * (
        Y - 2) * (X - 2)


def grad_fields_plain(fields, ghosts=None, clamp=None, *, dx=1.0):
    """Plain PyTorch version of :func:`grad_fields`, for any grid: the
    stencil with replicate reads at every cell, then the boundary ring
    replaced from the interior (the TPU kernel's rule, and for Z < 4 its
    ``fix_ring_replicate`` post-pass).  The slab form takes the gradients
    of the slab extended by its ghost planes (their x/y ring replicated),
    keeps the slab's planes and replicates the true edges' planes from
    their neighbours."""
    if ghosts is None:
        return grad_ring_replicate(fields, dx)
    out = grad_ring_replicate(torch.cat([ghosts[0], fields, ghosts[1]], dim=2),
                              dx)[:, :, 1:-1].contiguous()
    if clamp[0] > 0:
        out[:, :, 0] = out[:, :, 1]
    if clamp[1] < fields.shape[2]:
        out[:, :, -1] = out[:, :, -2]
    return out


def grad_fields(fields, ghosts=None, clamp=None, *, dx=1.0):
    """(gx, gy, gz) of each of N fields, ``[B, N, Z, Y, X]`` float32 ->
    ``[B, 3N, Z, Y, X]``, with the boundary ring replicated from the
    interior; with ``ghosts`` and ``clamp`` the slab form (module
    docstring).  Obstacle substitution is the caller's.  CPU tensors take
    the plain version; CUDA tensors launch the kernel,
    ``launches_per_call(B * N)`` times; anything else raises.  The input
    is not modified.

    The batch form: the kernel takes each field on its own and writes its
    three components side by side, so the B elements' N fields run as the
    B * N fields of one element (a view of the contiguous input), and the
    output ``[1, 3BN, ...]`` is the ``[B, 3N, ...]`` batch; each element's
    bits are those of a call on it alone."""
    if (ghosts is None) != (clamp is None):
        raise ValueError("grad_fields: give ghosts and clamp together, or neither")
    if fields.device.type == "cpu":
        return grad_fields_plain(fields, ghosts, clamp, dx=dx)
    check_no_grad("grad_fields", fields)
    B, n_fields, Z, Y, X = fields.shape
    check_batch("grad_fields", B)
    check_cuda("fields", fields, torch.float32, (B, n_fields, Z, Y, X))
    if ghosts is not None:
        for name, t in zip(("ghost_lo", "ghost_hi"), ghosts, strict=True):
            check_cuda(name, t, torch.float32, (B, n_fields, 1, Y, X))
        check_slab_clamp("grad_fields", clamp, Z, grad_fields.min_planes)
        ghosts = tuple(g.view(1, B * n_fields, 1, Y, X) for g in ghosts)
    if (min(Y, X, Z if ghosts is None else grad_fields.min_axis) < grad_fields.min_axis
            or n_fields < 1):
        raise ValueError(f"grad_fields needs Z, Y, X >= {grad_fields.min_axis} and at least "
                         "one field")
    out = torch.empty((B, 3 * n_fields, Z, Y, X), dtype=torch.float32, device=fields.device)
    flat, flat_out = fields.view(1, B * n_fields, Z, Y, X), out.view(1, -1, Z, Y, X)
    sms = torch.cuda.get_device_properties(fields.device).multi_processor_count
    f0 = 0
    for n in chunks(B * n_fields):
        pl = plan(Z, Y, X, sms, n)
        lo, hi = (None, None) if ghosts is None else (g[:, f0:f0 + n] for g in ghosts)
        call("lbm_grad_fields", ptr(flat[:, f0:f0 + n]), ptr(lo), ptr(hi),
             ptr(flat_out[:, 3 * f0:3 * (f0 + n)]), ctypes.c_int(n), ctypes.c_int(Z),
             ctypes.c_int(Y), ctypes.c_int(X), *(ctypes.c_int(v) for v in pl),
             *(ctypes.c_int(v) for v in (clamp or (1, Z - 2))), ctypes.c_double(dx),
             stream_of(fields))
        count_launch(grad_fields, False, None if ghosts is None else "slab", B)
        f0 += n
    return out


grad_fields.launches = 0
grad_fields.launches_bf16 = 0
grad_fields.launches_slab = 0
grad_fields.launches_batch = 0
#: cells an axis needs at least (the ring copies from the interior)
grad_fields.min_axis = 4
#: planes a slab of the slab form needs at least
grad_fields.min_planes = 2


def cost_laplacian(field, **_) -> tuple[int, int]:
    """(bytes, flops) that a call on this input must move and do: the field
    read and the Laplacian written once (8 B per cell); 21 flops per
    interior cell (the ring is written 0)."""
    _, _, Z, Y, X = field.shape
    return 8 * Z * Y * X, 21 * (Z - 2) * (Y - 2) * (X - 2)


def cost_laplacian_slab(field, ghosts=None, clamp=None, *, density_of=None,
                        **_) -> tuple[int, int]:
    """:func:`cost_laplacian` of the slab form: the two ghost planes read
    once more; the stencil at the planes that ``clamp`` computes (a true
    edge's plane takes the zero ring), and with ``density_of`` 3 flops a
    cell and ghost cell for the map."""
    _, _, Z, Y, X = field.shape
    planes = Z - (clamp[0] > 0) - (clamp[1] < Z)
    flops = 21 * planes * (Y - 2) * (X - 2)
    if density_of is not None:
        flops += 3 * (Z + 2) * Y * X
    return 8 * Z * Y * X + 8 * Y * X, flops


def laplacian_field_plain(field, ghosts=None, clamp=None, *, dx=1.0, density_of=None):
    """Plain PyTorch version of :func:`laplacian_field`.  The slab form
    takes the Laplacian of the slab extended by its ghost planes and
    zeroes the planes of the domain's true edges."""
    if density_of is not None:
        rho_gas, rho_fluid, density_gas, density_fluid = density_of

        def dens(x):
            return rho_to_density(x, rho_gas=rho_gas, rho_fluid=rho_fluid,
                                  density_gas=density_gas, density_fluid=density_fluid)

        field = dens(field)
        ghosts = None if ghosts is None else tuple(dens(t) for t in ghosts)
    if ghosts is None:
        return isotropic_laplacian(field, dx)
    lo, hi = ghosts
    out = isotropic_laplacian(torch.cat([lo, field, hi], dim=2), dx)[:, :, 1:-1].contiguous()
    if clamp[0] > 0:
        out[:, :, 0] = 0.0
    if clamp[1] < field.shape[2]:
        out[:, :, -1] = 0.0
    return out


def laplacian_field(field, ghosts=None, clamp=None, *, dx=1.0, density_of=None):
    """19-point Laplacian of ``[1, 1, Z, Y, X]`` float32, zero boundary
    ring; with ``ghosts`` and ``clamp`` the slab form, with ``density_of``
    of the density map of ``field`` (module docstring).  CPU tensors take
    the plain version; CUDA tensors launch the kernel; anything else
    raises.  The input is not modified."""
    if (ghosts is None) != (clamp is None):
        raise ValueError("laplacian_field: give ghosts and clamp together, or neither")
    if field.device.type == "cpu":
        return laplacian_field_plain(field, ghosts, clamp, dx=dx, density_of=density_of)
    check_no_grad("laplacian_field", field)
    B, C, Z, Y, X = field.shape
    check_unbatched("laplacian_field", B)
    check_cuda("field", field, torch.float32, (1, 1, Z, Y, X))
    if ghosts is not None:
        for name, t in zip(("ghost_lo", "ghost_hi"), ghosts, strict=True):
            check_cuda(name, t, torch.float32, (1, 1, 1, Y, X))
        check_slab_clamp("laplacian_field", clamp, Z, laplacian_field.min_planes)
    if min(Y, X, Z if ghosts is None else laplacian_field.min_axis) < laplacian_field.min_axis:
        raise ValueError(f"laplacian_field needs Z, Y, X >= {laplacian_field.min_axis}")
    out = torch.empty_like(field)
    pl = plan(Z, Y, X, torch.cuda.get_device_properties(field.device).multi_processor_count,
              laplacian=True)
    lo, hi = ghosts or (None, None)
    call("lbm_laplacian_field", ptr(field), ptr(lo), ptr(hi), ptr(out), ctypes.c_int(Z),
         ctypes.c_int(Y), ctypes.c_int(X), *(ctypes.c_int(v) for v in pl),
         *(ctypes.c_int(v) for v in (clamp or (1, Z - 2))), ctypes.c_double(dx),
         ctypes.c_int(density_of is not None),
         *(ctypes.c_double(float(v)) for v in (density_of or (0.0, 1.0, 0.0, 1.0))),
         stream_of(field))
    count_launch(laplacian_field, False, None if ghosts is None else "slab")
    return out


laplacian_field.launches = 0
laplacian_field.launches_bf16 = 0
laplacian_field.launches_slab = 0
#: planes a slab of the slab form needs at least
laplacian_field.min_planes = 2
#: cells an axis needs at least (the kernel's boundary ring)
laplacian_field.min_axis = 4


def capillary_stack(rho, flags, density, pressure, rho_ca, phi=None, *, rho_gas, rho_fluid,
                    density_gas, density_fluid, dx=1.0, dt=1.0):
    """The stencil route's B10b call and the fields its B10a call
    differentiates: (density(rho_ca), [lap, fai, prho] stacked, with chi
    of ``phi`` as a fourth field when it is given).  lap and chi are
    substituted at obstacles; fai and prho carry the interior on their
    ring already."""
    fai, prho = capillary_potentials(rho, density, pressure, dx=dx, dt=dt)
    density = rho_to_density(
        rho_ca, rho_gas=rho_gas, rho_fluid=rho_fluid,
        density_gas=density_gas, density_fluid=density_fluid,
    )
    stack = [substitute_obstacles(laplacian_field(density, dx=dx), flags), fai, prho]
    if phi is not None:
        stack.append(substitute_obstacles(chi_of_phi(phi, dx), flags))
    return density, torch.cat(stack, dim=1)


def hcz_capillary_stencils(
    rho, vel, flags, density, pressure, rho_ca, H2=None, phi=None, g_sum=None,
    g_mom=None, *, g=None, kappa, gravity, rho_gas, rho_fluid, density_gas,
    density_fluid, dx=1.0, dt=1.0,
):
    """The capillary stage through the stencil kernels: the arguments and
    returns of ``ops/collide.py:hcz_capillary``, computed as the JAX
    function's stencil route (``lbm_ferrofluid_tpu/ops/collide.py``
    :703-756): B10b on density(rho_ca); lap (and chi, with ``H2``/``phi``)
    substituted at obstacles (fai and prho already carry the interior on
    their ring); one B10a call on the stack [lap, fai, prho, (chi)]; the
    force, and velocity and pressure from ``g_sum``/``g_mom`` or, when
    absent, from the post-stream ``g``.  ``gravity`` is a
    ``[1, 3, 1, 1, 1]`` tensor.  CPU tensors run the kernels' plain
    versions."""
    if (H2 is None) != (phi is None):
        raise ValueError("hcz_capillary_stencils: give H2 and phi together, or neither")
    density, stack = capillary_stack(
        rho, flags, density, pressure, rho_ca, phi,
        rho_gas=rho_gas, rho_fluid=rho_fluid, density_gas=density_gas,
        density_fluid=density_fluid, dx=dx, dt=dt,
    )
    grads = grad_fields(stack, dx=dx)
    force = kappa * density * grads[:, 0:3] + gravity * density
    if H2 is not None:
        force = force - 0.5 * MU0 * H2 * grads[:, 9:12]
    # contiguous, as the collide kernels take them
    dfai, dprho = grads[:, 3:6].contiguous(), grads[:, 6:9].contiguous()
    vel, pressure = recover_macros(flags, vel, pressure, density, force, dprho, g_sum, g_mom,
                                   g, dx=dx, dt=dt)
    return rho_ca, vel, density, pressure, force, dfai, dprho
