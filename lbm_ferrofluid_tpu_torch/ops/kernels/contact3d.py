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

The slab form (``ghosts=(rho_lo, rho_hi), clamp=(bottom, top)``, the TPU
kernel's ghost mode, for a z-slab of a domain decomposed along z over
ranks: ``parallel/step3d.py``) takes one neighbour rho plane a side,
[1, 1, 1, Y, X] each, and runs the edge surgery only on the planes that
are the domain's true edges (``bottom``, ``top``); a slab-boundary plane
with a neighbour is an interior plane whose face terms read the ghost.
One launch (``launches_slab``); its plain version runs the surgery on the
slab extended by the ghosts where it has a neighbour.

A batch ``[B, 1, Z, Y, X]`` is one launch (a row of blocks an element),
each element's bits those of a call on it alone; the slab form takes one
element.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ...utils.types import CellType
from ..collide import contact_angle_boundary
from ._lib import call, check_batch, check_cuda, check_no_grad, count_launch, ptr, stream_of

__all__ = ["contact_angle_3d", "contact_angle_3d_plain", "cost", "cost_slab", "N_LAUNCHES"]

TPU_KERNEL = "lbm_ferrofluid_tpu/ops/pallas/contact3d.py:309"
CUDA_SOURCE = "lbm_ferrofluid_tpu_torch/csrc/contact3d.cu"
N_LAUNCHES = 1
#: the kernel indexes an element's cells with 32-bit integers, 4 to a thread
MAX_CELLS = 2**31 - 4096


def cost(rho, flags, contact_angle=None) -> tuple[int, int]:
    """(bytes, flops) that a call on these inputs must move and do.  Bytes:
    rho read and rho_ca written at every cell, flags read at the face cells
    (the interior of each of the 6 faces).  Flops: 9 per obstacle cell of
    an x or y face (two differences, two squares, two adds, sqrt,
    multiply-add; z faces are plain copies), 2 per edge-line cell, 3 per
    corner; each of the B elements of a batch counts."""
    B = flags.shape[0]
    Z, Y, X = flags.shape[-3:]
    obs = (flags == int(CellType.OBSTACLE))[:, 0]
    faces = 2 * ((Z - 2) * (Y - 2) + (Z - 2) * (X - 2) + (Y - 2) * (X - 2))
    xy_face_obs = int(obs[:, 1:-1, 1:-1, [0, -1]].sum() + obs[:, 1:-1, [0, -1], 1:-1].sum())
    edges = 4 * ((Z - 2) + (Y - 2) + (X - 2))
    return 8 * flags.numel() + B * faces, 9 * xy_face_obs + B * (2 * edges + 3 * 8)


def cost_slab(rho, flags, contact_angle=None, ghosts=None) -> tuple[int, int]:
    """:func:`cost` of the slab form: the two ghost planes read once more;
    the surgery's flops as counted over the whole domain (an upper bound
    on a slab's, which does the edge surgery only at true edges)."""
    nbytes, flops = cost(rho, flags)
    return nbytes + 8 * flags.shape[-2] * flags.shape[-1], flops


def contact_angle_3d_plain(rho, flags, contact_angle, ghosts=None, clamp=None):
    """Plain PyTorch version of :func:`contact_angle_3d`.  The slab form runs
    the surgery on the slab extended by the ghost plane on each side that
    is not a true edge (the ghost then stands at the extension's edge, and
    the slab's plane next to it is an interior plane) and keeps the slab's
    planes; the extension's flags are the slab's edge plane's, never read
    for a kept plane."""
    if ghosts is None:
        return contact_angle_boundary(rho, flags, contact_angle)
    bottom, top = clamp
    lo, hi = ghosts
    parts, fparts = [rho], [flags]
    if not bottom:
        parts.insert(0, lo)
        fparts.insert(0, flags[:, :, :1])
    if not top:
        parts.append(hi)
        fparts.append(flags[:, :, -1:])
    out = contact_angle_boundary(torch.cat(parts, dim=2), torch.cat(fparts, dim=2),
                                 contact_angle)
    Z = rho.shape[2]
    start = 0 if bottom else 1
    return out[:, :, start:start + Z]


def contact_angle_3d(rho, flags, contact_angle, ghosts=None, clamp=None):
    """rho [B, 1, Z, Y, X] float32 and flags [B, 1, Z, Y, X] uint8 ->
    rho_ca, the B elements in one launch; with ``ghosts`` and ``clamp`` the
    slab form (B = 1).  CPU tensors take
    the plain version; CUDA tensors launch the kernel on their card;
    anything else raises.  ``rho`` is not modified."""
    if (ghosts is None) != (clamp is None):
        raise ValueError("contact_angle_3d: give ghosts and clamp together, or neither")
    if rho.device.type == "cpu":
        return contact_angle_3d_plain(rho, flags, contact_angle, ghosts, clamp)
    check_no_grad("contact_angle_3d", rho)
    B, C, Z, Y, X = rho.shape
    check_batch("contact_angle_3d", B, ghosts is not None)
    check_cuda("rho", rho, torch.float32, (B, 1, Z, Y, X))
    check_cuda("flags", flags, torch.uint8, (B, 1, Z, Y, X))
    if ghosts is not None:
        for name, t in zip(("rho_lo", "rho_hi"), ghosts, strict=True):
            check_cuda(name, t, torch.float32, (1, 1, 1, Y, X))
    if min(Z, Y, X) < contact_angle_3d.min_axis:
        raise ValueError(f"contact_angle_3d needs Z, Y, X >= {contact_angle_3d.min_axis}")
    if Z * Y * X > MAX_CELLS:
        raise ValueError(f"contact_angle_3d takes at most {MAX_CELLS} cells an element")
    out = torch.empty_like(rho)
    # 16-byte loads and stores where every plane's groups of 4 cells are aligned
    vec = (Y * X) % 4 == 0 and rho.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    t = ctypes.c_double(math.tan(math.pi / 2.0 - float(contact_angle)))
    lo, hi = ghosts if ghosts is not None else (None, None)
    bottom, top = clamp if clamp is not None else (1, 1)
    call("lbm_contact_angle", ptr(rho), ptr(flags), ptr(out), ctypes.c_int(B), ctypes.c_int(Z),
         ctypes.c_int(Y), ctypes.c_int(X), t, ctypes.c_int(vec), ptr(lo), ptr(hi),
         ctypes.c_int(int(bool(bottom))), ctypes.c_int(int(bool(top))), stream_of(rho))
    count_launch(contact_angle_3d, False, "slab" if ghosts is not None else None, B)
    return out


contact_angle_3d.launches = 0
contact_angle_3d.launches_bf16 = 0
contact_angle_3d.launches_slab = 0
contact_angle_3d.launches_batch = 0
#: cells an axis needs at least (below that, a face reads cells its own
#: stage writes, and the one-pass rule does not hold)
contact_angle_3d.min_axis = 4
