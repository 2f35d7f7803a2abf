"""B2: the contact-angle surgery on rho.

Replaces the TPU kernel ``lbm_ferrofluid_tpu/ops/pallas/contact3d.py:
contact_angle_3d`` (:309).  The surgery is order-dependent (x faces, y faces
reading the updated x borders, z faces, edge lines, corners), so the CUDA
source ``csrc/contact3d.cu`` runs one launch per dependency stage: a
whole-volume copy that also writes the x faces, then five launches over
boundary cells only.  A call is 6 launches.  The plain version is
``ops/collide.py:contact_angle_boundary``.

Bound on an H100: bytes, 8 B per cell plus 1 B per face cell (read rho,
write rho_ca once, read the uint8 flags only at face cells): 0.040 ms at
256^3 over 3.35 TB/s.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ...utils.types import CellType
from ..collide import contact_angle_boundary
from ._lib import call, check_cuda, ptr, stream_of

__all__ = ["contact_angle_3d", "contact_angle_3d_plain", "cost"]

TPU_KERNEL = "lbm_ferrofluid_tpu/ops/pallas/contact3d.py:309"
CUDA_SOURCE = "lbm_ferrofluid_tpu_torch/csrc/contact3d.cu"
N_STAGES = 6


def cost(rho, flags, contact_angle=None) -> tuple[int, int]:
    """(bytes, flops) that a call on these inputs must move and do.  Bytes:
    rho read and rho_ca written at every cell, flags read at the face cells
    (the interior of each of the 6 faces).  Flops: 9 per obstacle cell of
    an x or y face (two differences, two squares, two adds, sqrt,
    multiply-add; z faces are plain copies), 2 per edge-line cell, 3 per
    corner."""
    Z, Y, X = flags.shape[-3:]
    obs = (flags == int(CellType.OBSTACLE))[0, 0]
    faces = 2 * ((Z - 2) * (Y - 2) + (Z - 2) * (X - 2) + (Y - 2) * (X - 2))
    xy_face_obs = int(obs[1:-1, 1:-1, [0, -1]].sum() + obs[1:-1, [0, -1], 1:-1].sum())
    edges = 4 * ((Z - 2) + (Y - 2) + (X - 2))
    return 8 * flags.numel() + faces, 9 * xy_face_obs + 2 * edges + 3 * 8


def contact_angle_3d_plain(rho, flags, contact_angle):
    """Plain PyTorch version of :func:`contact_angle_3d`."""
    return contact_angle_boundary(rho, flags, contact_angle)


def contact_angle_3d(rho, flags, contact_angle):
    """rho [1, 1, Z, Y, X] float32 and flags [1, 1, Z, Y, X] uint8 ->
    rho_ca.  CPU tensors take the plain version; CUDA tensors launch the
    kernel; anything else raises.  ``rho`` is not modified."""
    if rho.device.type == "cpu":
        return contact_angle_3d_plain(rho, flags, contact_angle)
    B, C, Z, Y, X = rho.shape
    check_cuda("rho", rho, torch.float32, (1, 1, Z, Y, X))
    check_cuda("flags", flags, torch.uint8, (1, 1, Z, Y, X))
    if min(Z, Y, X) < contact_angle_3d.min_axis:
        raise ValueError(f"contact_angle_3d needs Z, Y, X >= {contact_angle_3d.min_axis}")
    out = torch.empty_like(rho)
    t = ctypes.c_double(math.tan(math.pi / 2.0 - float(contact_angle)))
    st = stream_of(rho)
    for stage in range(N_STAGES):
        call("lbm_contact_angle_stage", ctypes.c_int(stage), ptr(rho),
             ptr(flags), ptr(out), ctypes.c_int(Z), ctypes.c_int(Y), ctypes.c_int(X),
             t, st)
        contact_angle_3d.launches += 1
    return out


contact_angle_3d.launches = 0
#: cells an axis needs at least (below that, a stage reads cells it writes)
contact_angle_3d.min_axis = 4
