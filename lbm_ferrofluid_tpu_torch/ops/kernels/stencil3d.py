"""B10a and B10b: the capillary stencils, and the capillary stage's stencil
route built from them.

B10a replaces the TPU kernel ``lbm_ferrofluid_tpu/ops/pallas/stencil3d.py:
grad_fields`` (:176) in its single-device form: 19-point isotropic
gradients of N stacked fields.  One thread per output cell evaluates the
gradient around the nearest interior cell, which is the TPU kernel's
boundary-ring rule (output ring replicated from the interior, x edges
first, then y, then z).  The channel-form magnetic solve uses it on the
obstacle-substituted psi (``ops/magnetic.py:solve_H_int``).

B10b replaces ``laplacian_field`` (:242): the 19-point Laplacian with a zero
boundary ring (x/y edges everywhere, whole z edge planes), one thread per
cell.  The plain version is ``ops/stencils.py:isotropic_laplacian``.

Both are in ``csrc/stencil3d.cu``; a call is one launch.
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

import torch

from ..collide import MU0, capillary_potentials, chi_of_phi, recover_macros
from ..moments import rho_to_density
from ..stencils import grad_ring_replicate, isotropic_laplacian, substitute_obstacles
from ._lib import call, check_cuda, ptr, stream_of

__all__ = [
    "grad_fields", "grad_fields_plain", "cost", "laplacian_field", "laplacian_field_plain",
    "cost_laplacian", "hcz_capillary_stencils",
]

TPU_KERNEL = "lbm_ferrofluid_tpu/ops/pallas/stencil3d.py:176"
TPU_KERNEL_LAPLACIAN = "lbm_ferrofluid_tpu/ops/pallas/stencil3d.py:242"
CUDA_SOURCE = "lbm_ferrofluid_tpu_torch/csrc/stencil3d.cu"


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
    plain version; CUDA tensors launch the kernel; anything else raises.
    The input is not modified."""
    if fields.device.type == "cpu":
        return grad_fields_plain(fields, dx=dx)
    B, n_fields, Z, Y, X = fields.shape
    check_cuda("fields", fields, torch.float32, (1, n_fields, Z, Y, X))
    if min(Z, Y, X) < grad_fields.min_axis or n_fields < 1:
        raise ValueError(f"grad_fields needs Z, Y, X >= {grad_fields.min_axis} and at least "
                         "one field")
    out = torch.empty((1, 3 * n_fields, Z, Y, X), dtype=torch.float32, device=fields.device)
    call("lbm_grad_fields", ptr(fields), ptr(out), ctypes.c_int(n_fields), ctypes.c_int(Z),
         ctypes.c_int(Y), ctypes.c_int(X), ctypes.c_double(dx), stream_of(fields))
    grad_fields.launches += 1
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
    call("lbm_laplacian_field", ptr(field), ptr(out), ctypes.c_int(Z), ctypes.c_int(Y),
         ctypes.c_int(X), ctypes.c_double(dx), stream_of(field))
    laplacian_field.launches += 1
    return out


laplacian_field.launches = 0
#: cells an axis needs at least (the kernel's boundary ring)
laplacian_field.min_axis = 4


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
    fai, prho = capillary_potentials(rho, density, pressure, dx=dx, dt=dt)
    density = rho_to_density(
        rho_ca, rho_gas=rho_gas, rho_fluid=rho_fluid,
        density_gas=density_gas, density_fluid=density_fluid,
    )
    stack = [substitute_obstacles(laplacian_field(density, dx=dx), flags), fai, prho]
    if H2 is not None:
        stack.append(substitute_obstacles(chi_of_phi(phi, dx), flags))
    grads = grad_fields(torch.cat(stack, dim=1), dx=dx)
    force = kappa * density * grads[:, 0:3] + gravity * density
    if H2 is not None:
        force = force - 0.5 * MU0 * H2 * grads[:, 9:12]
    # contiguous, as the collide kernels take them
    dfai, dprho = grads[:, 3:6].contiguous(), grads[:, 6:9].contiguous()
    vel, pressure = recover_macros(flags, vel, pressure, density, force, dprho, g_sum, g_mom,
                                   g, dx=dx, dt=dt)
    return rho_ca, vel, density, pressure, force, dfai, dprho
