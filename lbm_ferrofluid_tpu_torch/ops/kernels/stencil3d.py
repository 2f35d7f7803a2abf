"""B10a: 19-point isotropic gradients of N stacked fields.

Replaces the TPU kernel ``lbm_ferrofluid_tpu/ops/pallas/stencil3d.py:
grad_fields`` (:176) in its single-device form.  The CUDA source is
``csrc/stencil3d.cu``: one thread per output cell evaluates the gradient
around the nearest interior cell, which is the TPU kernel's boundary-ring
rule (output ring replicated from the interior, x edges first, then y,
then z).  A call is one launch.  The channel-form magnetic solve uses it
on the obstacle-substituted psi (``ops/magnetic.py:solve_H_int``).

Bound on an H100 (card peaks from NVIDIA's data sheet): bytes, 16 B per
cell and field, 0.080 ms at 256^3 for one field over 3.35 TB/s.
"""

from __future__ import annotations

import ctypes

import torch

from ..stencils import grad_ring_replicate
from ._lib import call, check_cuda, ptr, stream_of

__all__ = ["grad_fields", "grad_fields_plain", "cost"]

TPU_KERNEL = "lbm_ferrofluid_tpu/ops/pallas/stencil3d.py:176"
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
    if min(Z, Y, X) < 4 or n_fields < 1:
        raise ValueError("grad_fields needs Z, Y, X >= 4 and at least one field")
    out = torch.empty((1, 3 * n_fields, Z, Y, X), dtype=torch.float32, device=fields.device)
    call("lbm_grad_fields", ptr(fields), ptr(out), ctypes.c_int(n_fields), ctypes.c_int(Z),
         ctypes.c_int(Y), ctypes.c_int(X), ctypes.c_double(dx), stream_of(fields))
    grad_fields.launches += 1
    return out


grad_fields.launches = 0
