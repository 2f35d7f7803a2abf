"""B2: the contact-angle surgery on rho.

Replaces the TPU kernel ``lbm_ferrofluid_tpu/ops/pallas/contact3d.py:
contact_angle_3d`` (:309).  The surgery is order-dependent (x faces, y faces
reading the updated x borders, z faces, edge lines, corners), but every
value a stage reads from an earlier one is a closed-form function of rho
and flags, so the CUDA source ``csrc/contact3d.cu`` runs it as one launch
over the whole volume: interior cells copy rho, and each boundary cell
recomputes in registers what the stages before its own wrote.  A call is
``N_LAUNCHES`` = 1 launch, and equals the plain version
``ops/collide.py:contact_angle_boundary`` bit for bit.

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

__all__ = ["contact_angle_3d", "contact_angle_3d_plain", "cost", "N_LAUNCHES"]

TPU_KERNEL = "lbm_ferrofluid_tpu/ops/pallas/contact3d.py:309"
CUDA_SOURCE = "lbm_ferrofluid_tpu_torch/csrc/contact3d.cu"
N_LAUNCHES = 1
#: the kernel indexes cells with 32-bit integers, 4 to a thread
MAX_CELLS = 2**31 - 4096


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
    if rho.numel() > MAX_CELLS:
        raise ValueError(f"contact_angle_3d takes at most {MAX_CELLS} cells")
    out = torch.empty_like(rho)
    # 16-byte loads and stores where every plane's groups of 4 cells are aligned
    vec = (Y * X) % 4 == 0 and rho.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    t = ctypes.c_double(math.tan(math.pi / 2.0 - float(contact_angle)))
    call("lbm_contact_angle", ptr(rho), ptr(flags), ptr(out), ctypes.c_int(Z),
         ctypes.c_int(Y), ctypes.c_int(X), t, ctypes.c_int(vec), stream_of(rho))
    contact_angle_3d.launches += 1
    return out


contact_angle_3d.launches = 0
#: cells an axis needs at least (below that, a face reads cells its own
#: stage writes, and the one-pass rule does not hold)
contact_angle_3d.min_axis = 4
