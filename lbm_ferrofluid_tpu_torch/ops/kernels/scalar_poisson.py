"""B1: the tau == 1 scalar Poisson sweeps with the in-kernel H2 emission.

Replaces the TPU kernel ``lbm_ferrofluid_tpu/ops/pallas/scalar_poisson.py:
scalar_wavefront`` (:562) with ``emit="h2"``.  The CUDA source is
``csrc/scalar_poisson.cu``: one launch per sweep over the volume (periodic
wrap on all three axes, the grouped tap order ``A·W1 + D·W2 + c·s_prev``
of ``_cmask_sweeps_jnp``), rotating three buffers because a sweep reads
the 18 neighbours of s; the last sweep also writes psi, and a final launch
composes H2 = |h_ext - grad psi_sub|^2.  A call is ``n_iters + 1`` launches.

Bound on an H100 (card peaks from NVIDIA's data sheet): see :func:`cost`;
at 30 sweeps the float32 operation rate bounds it (0.16 ms at 256^3
against 0.12 ms for the bytes).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ...utils.types import CellType
from ..magnetic import maybe_h2
from ..stencils import isotropic_grad
from ._lib import call, check_cuda, ptr, stream_of

__all__ = [
    "scalar_wavefront",
    "scalar_wavefront_plain",
    "scalar_sweeps_plain",
    "h2_from_psi_plain",
    "cost",
]

TPU_KERNEL = "lbm_ferrofluid_tpu/ops/pallas/scalar_poisson.py:562"
CUDA_SOURCE = "lbm_ferrofluid_tpu_torch/csrc/scalar_poisson.cu"

#: the TPU kernel's grouped tap weights, f32(1.5/18) and f32(1.5/36)
W1 = float(np.float32(1.5 / 18.0))
W2 = float(np.float32(1.5 / 36.0))

_AXIS_SH = [(0, 0, 1), (0, 0, -1), (0, 1, 0), (0, -1, 0), (1, 0, 0), (-1, 0, 0)]
_DIAG_SH = [(0, 1, 1), (0, 1, -1), (0, -1, 1), (0, -1, -1),
            (1, 0, 1), (1, 0, -1), (-1, 0, 1), (-1, 0, -1),
            (1, 1, 0), (1, -1, 0), (-1, 1, 0), (-1, -1, 0)]


def cost(s2, cmask, rhs_scaled, *, n_iters, **_) -> tuple[int, int]:
    """(bytes, flops) that a call on these inputs must move and do.

    Bytes: s and cmask read at every cell, s_prev only where c > 0 (the
    wall-adjacent fluid cells) and rhs only at fluid cells (s' is 0 at
    obstacles); s', s_prev' and H2 written at every cell.  Flops: per
    sweep 20 per fluid cell (5 + 11 tap adds, 2 multiplies and 2 adds for
    psi, 1 for s') and 2 more where c > 0 (c * s_prev); for H2, 36 per
    interior cell (the gradient; the ring replicates it) and 8 per cell."""
    n = cmask.numel()
    n_fluid = int((cmask >= 0).sum())
    n_wall = int((cmask > 0).sum())
    Z, Y, X = cmask.shape[-3:]
    nbytes = 20 * n + 4 * (n_fluid + n_wall)
    nflops = n_iters * (20 * n_fluid + 2 * n_wall) + 36 * (Z - 2) * (Y - 2) * (X - 2) + 8 * n
    return nbytes, nflops


def scalar_sweeps_plain(s2, cmask, rhs_scaled, n_iters):
    """``n_iters`` sweeps in plain PyTorch; returns (s2', psi of the last
    sweep).  The twin of ``_cmask_sweeps_jnp``: same taps, same order."""
    s, s_prev = s2[:, 0:1], s2[:, 1:2]
    mask = (cmask >= 0.0).to(s2.dtype)
    c_pos = torch.clamp(cmask, min=0.0)
    psi = torch.zeros_like(s)
    for _ in range(n_iters):
        A = None
        for sh in _AXIS_SH:
            t = torch.roll(s, sh, dims=(-3, -2, -1))
            A = t if A is None else A + t
        D = None
        for sh in _DIAG_SH:
            t = torch.roll(s, sh, dims=(-3, -2, -1))
            D = t if D is None else D + t
        psi = A * W1 + D * W2 + c_pos * s_prev
        s, s_prev = (psi + rhs_scaled) * mask, s
    return torch.cat([s, s_prev], dim=1), psi


def h2_from_psi_plain(psi, cmask, dx, h_ext):
    """H2 = |h_ext - grad(psi_sub)|^2: obstacle psi replaced by the
    edge-replicated interior, 19-point isotropic gradient with replicate
    edges (``solve_H_int_scalar`` :236-243 with ``_maybe_h2``)."""
    flags = torch.where(cmask < 0, int(CellType.OBSTACLE), int(CellType.FLUID))
    return maybe_h2(-isotropic_grad(psi, dx, flags), h_ext)


def scalar_wavefront_plain(s2, cmask, rhs_scaled, *, n_iters, dx=1.0, h_ext):
    """Plain PyTorch version of :func:`scalar_wavefront`."""
    s2, psi = scalar_sweeps_plain(s2, cmask, rhs_scaled, n_iters)
    return s2, h2_from_psi_plain(psi, cmask, dx, h_ext)


def scalar_wavefront(s2, cmask, rhs_scaled, *, n_iters, dx=1.0, h_ext):
    """``n_iters`` scalar sweeps on the fused (s, s_prev) pair, then H2.

    ``s2``: [1, 2, Z, Y, X] float32, both channels fluid-masked;
    ``cmask``: [1, 1, Z, Y, X] float32, -1 at obstacles, c(x) >= 0 at fluid
    cells; ``rhs_scaled``: [1, 1, Z, Y, X] float32; ``h_ext`` a 3-tuple.
    Returns (s2', H2).  CPU tensors take the plain version; CUDA tensors
    launch the kernel; anything else raises.  Inputs are not modified.
    """
    if s2.device.type == "cpu":
        return scalar_wavefront_plain(
            s2, cmask, rhs_scaled, n_iters=n_iters, dx=dx, h_ext=h_ext
        )
    B, C, Z, Y, X = s2.shape
    check_cuda("s2", s2, torch.float32, (1, 2, Z, Y, X))
    check_cuda("cmask", cmask, torch.float32, (1, 1, Z, Y, X))
    check_cuda("rhs_scaled", rhs_scaled, torch.float32, (1, 1, Z, Y, X))
    if min(Z, Y, X) < 3 or n_iters < 1 or len(h_ext) != 3:
        raise ValueError("scalar_wavefront needs Z, Y, X >= 3, n_iters >= 1 and a 3-tuple h_ext")
    out = torch.empty_like(s2)
    spare = torch.empty_like(cmask)
    psi = torch.empty_like(cmask)
    h2 = torch.empty_like(cmask)
    # sweep k writes s_k; counting back from the last sweep, s_n goes to
    # out[:, 0], s_{n-1} to out[:, 1], s_{n-2} to spare, and so on, so no
    # sweep overwrites the two fields it reads
    rot = [out[:, 0], out[:, 1], spare[:, 0]]
    dims = (ctypes.c_int(Z), ctypes.c_int(Y), ctypes.c_int(X))
    st = stream_of(s2)
    s, sp = s2[:, 0], s2[:, 1]
    for k in range(1, n_iters + 1):
        dst = rot[(n_iters - k) % 3]
        call("lbm_scalar_sweep",ptr(s), ptr(sp), ptr(cmask),
             ptr(rhs_scaled), ptr(dst), ptr(psi if k == n_iters else None),
             *dims, st)
        scalar_wavefront.launches += 1
        s, sp = dst, s
    if n_iters == 1:
        out[:, 1].copy_(s2[:, 0])
    call("lbm_scalar_h2",ptr(psi), ptr(cmask), ptr(h2), *dims,
         ctypes.c_double(dx), *(ctypes.c_double(float(v)) for v in h_ext), st)
    scalar_wavefront.launches += 1
    return out, h2


scalar_wavefront.launches = 0
