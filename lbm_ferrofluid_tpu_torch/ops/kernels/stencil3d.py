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
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..collide import MU0, capillary_potentials, chi_of_phi, recover_macros
from ..moments import rho_to_density
from ..stencils import grad_ring_replicate, isotropic_laplacian, substitute_obstacles
from ._lib import call, check_cuda, ptr, stream_of

__all__ = [
    "grad_fields", "grad_fields_plain", "cost", "laplacian_field", "laplacian_field_plain",
    "cost_laplacian", "capillary_stack", "hcz_capillary_stencils", "plan", "StencilPlan", "chunks",
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
    """B10a's launches for ``n_fields`` fields: one a chunk."""
    return len(chunks(n_fields))


def cost(fields, **_) -> tuple[int, int]:
    """(bytes, flops) that a call on these inputs must move and do: each
    field read once and its three components written once (16 B per cell
    and field); 33 flops per interior cell and field (the ring copies the
    interior)."""
    _, n_fields, Z, Y, X = fields.shape
    n = Z * Y * X
    return 16 * n_fields * n, 33 * n_fields * (Z - 2) * (Y - 2) * (X - 2)


def grad_fields_plain(fields, *, dx=1.0):
    """Plain PyTorch version of :func:`grad_fields`, for any grid: the
    stencil with replicate reads at every cell, then the boundary ring
    replaced from the interior (the TPU kernel's rule, and for Z < 4 its
    ``fix_ring_replicate`` post-pass)."""
    return grad_ring_replicate(fields, dx)


def grad_fields(fields, *, dx=1.0):
    """(gx, gy, gz) of each of N fields, ``[1, N, Z, Y, X]`` float32 ->
    ``[1, 3N, Z, Y, X]``, with the boundary ring replicated from the
    interior.  Obstacle substitution is the caller's.  CPU tensors take the
    plain version; CUDA tensors launch the kernel, ``launches_per_call``
    times; anything else raises.  The input is not modified."""
    if fields.device.type == "cpu":
        return grad_fields_plain(fields, dx=dx)
    B, n_fields, Z, Y, X = fields.shape
    check_cuda("fields", fields, torch.float32, (1, n_fields, Z, Y, X))
    if min(Z, Y, X) < grad_fields.min_axis or n_fields < 1:
        raise ValueError(f"grad_fields needs Z, Y, X >= {grad_fields.min_axis} and at least "
                         "one field")
    out = torch.empty((1, 3 * n_fields, Z, Y, X), dtype=torch.float32, device=fields.device)
    sms = torch.cuda.get_device_properties(fields.device).multi_processor_count
    f0 = 0
    for n in chunks(n_fields):
        pl = plan(Z, Y, X, sms, n)
        call("lbm_grad_fields", ptr(fields[:, f0:f0 + n]), ptr(out[:, 3 * f0:3 * (f0 + n)]),
             ctypes.c_int(n), ctypes.c_int(Z), ctypes.c_int(Y), ctypes.c_int(X),
             *(ctypes.c_int(v) for v in pl), ctypes.c_double(dx), stream_of(fields))
        grad_fields.launches += 1
        f0 += n
    return out


grad_fields.launches = 0
#: cells an axis needs at least (the ring copies from the interior)
grad_fields.min_axis = 4


def cost_laplacian(field, **_) -> tuple[int, int]:
    """(bytes, flops) that a call on this input must move and do: the field
    read and the Laplacian written once (8 B per cell); 21 flops per
    interior cell (the ring is written 0)."""
    _, _, Z, Y, X = field.shape
    return 8 * Z * Y * X, 21 * (Z - 2) * (Y - 2) * (X - 2)


def laplacian_field_plain(field, *, dx=1.0):
    """Plain PyTorch version of :func:`laplacian_field`."""
    return isotropic_laplacian(field, dx)


def laplacian_field(field, *, dx=1.0):
    """19-point Laplacian of ``[1, 1, Z, Y, X]`` float32, zero boundary
    ring.  CPU tensors take the plain version; CUDA tensors launch the
    kernel; anything else raises.  The input is not modified."""
    if field.device.type == "cpu":
        return laplacian_field_plain(field, dx=dx)
    B, C, Z, Y, X = field.shape
    check_cuda("field", field, torch.float32, (1, 1, Z, Y, X))
    if min(Z, Y, X) < laplacian_field.min_axis:
        raise ValueError(f"laplacian_field needs Z, Y, X >= {laplacian_field.min_axis}")
    out = torch.empty_like(field)
    pl = plan(Z, Y, X, torch.cuda.get_device_properties(field.device).multi_processor_count,
              laplacian=True)
    call("lbm_laplacian_field", ptr(field), ptr(out), ctypes.c_int(Z), ctypes.c_int(Y),
         ctypes.c_int(X), *(ctypes.c_int(v) for v in pl), ctypes.c_double(dx),
         stream_of(field))
    laplacian_field.launches += 1
    return out


laplacian_field.launches = 0
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
