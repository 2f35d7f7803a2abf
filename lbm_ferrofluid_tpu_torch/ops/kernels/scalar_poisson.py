"""B1: the tau == 1 scalar Poisson sweeps with the in-kernel H2 emission.

Replaces the TPU kernel ``lbm_ferrofluid_tpu/ops/pallas/scalar_poisson.py:
scalar_wavefront`` (:562) with ``emit="h2"``.  The CUDA source is
``csrc/scalar_poisson.cu``.  A call runs the sweeps as passes of k sweeps,
each one launch of a z-wavefront (the TPU's schedule rethought for a
227 KB SM): a block holds an (x, y) tile with a k-cell halo and walks its
chunk of z with k stages, one plane apart, each in a 3-plane ring of shared
memory.  A pass runs k = ``K`` = 3 sweeps on 26 x 28 tiles, and a
remainder pass ``n_iters mod 3`` with the same kernel; :func:`plan` picks
the z chunk for the card's SM count.  The last pass also writes psi, and
one more launch composes H2 = |h_ext - grad psi_sub|^2.  A call is
:func:`launches_per_call` launches: 11 at 30 sweeps.  The sweeps keep the
grouped tap order ``A·W1 + D·W2 + c·s_prev`` of ``_cmask_sweeps_jnp``.

Bound on an H100 (card peaks from NVIDIA's data sheet): see :func:`cost`;
at 30 sweeps the float32 operation rate bounds it (0.16 ms at 256^3
against 0.12 ms for the bytes).
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from ...utils.types import CellType
from ..magnetic import maybe_h2
from ..stencils import isotropic_grad
from ._lib import call, check_cuda, check_no_grad, ptr, stream_of

__all__ = [
    "ScalarPlan",
    "passes",
    "plan",
    "launches_per_call",
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

#: the pass kernel's shape (csrc/scalar_poisson.cu: SP_EX, SP_R, SP_MAX_K,
#: SP_MAX_EY): extended tiles 32 cells wide (so tiles are 32 - 2k wide), a
#: thread computes 4 cells of a column
EXT_WIDTH = 32
ROWS = 4
MAX_K = 6
MAX_EXT_HEIGHT = 48
#: shared memory one block may use on an H100 (SP_SMEM_MAX), and the SM's
#: (228 KB, of which 1 KB is reserved for each resident block)
SMEM_BLOCK_MAX = 232_448
SMEM_SM = 233_472
#: sweeps a pass and tile height: with the z chunk :func:`plan` picks, the
#: fastest plan timed at 256^3 and at 130x66x130 on an H100
#: (``python3 chip_smoke.py --scalar-plans`` times k = 1..6 and tile heights)
K = 3
TY = 28

_AXIS_SH = [(0, 0, 1), (0, 0, -1), (0, 1, 0), (0, -1, 0), (1, 0, 0), (-1, 0, 0)]
_DIAG_SH = [(0, 1, 1), (0, 1, -1), (0, -1, 1), (0, -1, -1),
            (1, 0, 1), (1, 0, -1), (-1, 0, 1), (-1, 0, -1),
            (1, 1, 0), (1, -1, 0), (-1, 1, 0), (-1, -1, 0)]


def smem_bytes(k: int, ty: int) -> int:
    """Shared memory of one pass block: 4 floats of padding, the extended
    tile's k 3-plane stage rings, (k + 2)-plane cmask and rhs rings and
    3-plane s_prev ring, then its wrapped column and row indices."""
    ey = ty + 2 * k
    return 4 * (4 + EXT_WIDTH * ey * (3 * k + 2 * (k + 2) + 3) + EXT_WIDTH + ey)


@dataclass(frozen=True)
class ScalarPlan:
    """How a call runs its sweeps: ``passes`` (sweeps per launch; all ``k``
    but a remainder), on tiles ``32 - 2 * sweeps`` wide and ``ty`` high and
    z chunks of ``lz`` planes."""

    k: int
    ty: int
    lz: int
    passes: tuple


def _check(Z, Y, X, n_iters):
    if min(Z, Y, X) < 3 or n_iters < 1:
        raise ValueError("scalar sweeps need Z, Y, X >= 3 and n_iters >= 1")


def passes(n_iters: int) -> tuple:
    """Sweeps of each pass: ``K`` (all ``n_iters`` where fewer), then a
    remainder pass of ``n_iters mod K``."""
    k = min(K, n_iters)
    return (k,) * (n_iters // k) + ((n_iters % k,) if n_iters % k else ())


@functools.lru_cache(maxsize=None)
def plan(Z: int, Y: int, X: int, n_iters: int, sms: int) -> ScalarPlan:
    """The passes of ``n_iters`` sweeps on a Z x Y x X grid, on a card of
    ``sms`` SMs.

    Every pass runs on (32 - 2k) x ``TY`` tiles.  The z chunk: a block (a
    tile and a chunk) walks lz + 2k planes, and the blocks run in waves of
    as many as the SMs hold, so lz minimises waves x (lz + 2k); ties go to
    the larger lz.  Raises where a pass block would need more than
    ``SMEM_BLOCK_MAX`` of shared memory.
    """
    _check(Z, Y, X, n_iters)
    ps = passes(n_iters)
    k = ps[0]
    smem = smem_bytes(k, TY)
    if smem > SMEM_BLOCK_MAX:
        raise ValueError(f"a pass of {k} sweeps on {TY}-row tiles needs {smem} B of shared "
                         f"memory, more than {SMEM_BLOCK_MAX}")
    # resident blocks an SM: shared memory allows, __launch_bounds__(256, 2) asks 2
    slots = min(2, SMEM_SM // (smem + 1024)) * sms
    tiles = -(-X // (EXT_WIDTH - 2 * k)) * -(-Y // TY)

    def ticks(lz):
        return -(-tiles * -(-Z // lz) // slots) * (lz + 2 * k)

    lz = min(sorted({-(-Z // c) for c in range(1, Z + 1)}, reverse=True), key=ticks)
    return ScalarPlan(k, TY, lz, ps)


def launches_per_call(n_iters: int, shape) -> int:
    """Launches of one :func:`scalar_wavefront` call on a grid of ``shape``
    (its last three entries are Z, Y, X): the passes and H2."""
    _check(*shape[-3:], n_iters)
    return len(passes(n_iters)) + 1


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
    check_no_grad("scalar_wavefront", s2, cmask, rhs_scaled)
    B, C, Z, Y, X = s2.shape
    check_cuda("s2", s2, torch.float32, (1, 2, Z, Y, X))
    check_cuda("cmask", cmask, torch.float32, (1, 1, Z, Y, X))
    check_cuda("rhs_scaled", rhs_scaled, torch.float32, (1, 1, Z, Y, X))
    if min(Z, Y, X) < 3 or n_iters < 1 or len(h_ext) != 3:
        raise ValueError("scalar_wavefront needs Z, Y, X >= 3, n_iters >= 1 and a 3-tuple h_ext")
    pl = plan(Z, Y, X, n_iters, torch.cuda.get_device_properties(s2.device).multi_processor_count)
    out = torch.empty_like(s2)
    # pass i writes out when an even number of passes follows it, else tmp:
    # each pass reads the pair the one before it wrote, and the last writes out
    tmp = torch.empty_like(s2) if len(pl.passes) > 1 else None
    psi = torch.empty_like(cmask)
    h2 = torch.empty_like(cmask)
    dims = (ctypes.c_int(Z), ctypes.c_int(Y), ctypes.c_int(X))
    st = stream_of(s2)
    src = s2
    for i, k in enumerate(pl.passes):
        after = len(pl.passes) - 1 - i
        dst = out if after % 2 == 0 else tmp
        call("lbm_scalar_pass", ptr(src[:, 0]), ptr(src[:, 1]), ptr(cmask), ptr(rhs_scaled),
             ptr(dst[:, 0]), ptr(dst[:, 1]), ptr(None if after else psi), *dims,
             ctypes.c_int(k), ctypes.c_int(pl.ty), ctypes.c_int(pl.lz), st)
        scalar_wavefront.launches += 1
        src = dst
    call("lbm_scalar_h2", ptr(psi), ptr(cmask), ptr(h2), *dims,
         ctypes.c_double(dx), *(ctypes.c_double(float(v)) for v in h_ext), st)
    scalar_wavefront.launches += 1
    return out, h2


scalar_wavefront.launches = 0
