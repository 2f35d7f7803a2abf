"""B11b, serving B7, B11a and B12: channel-form magnetic Poisson sweeps.

Replaces the TPU kernel ``lbm_ferrofluid_tpu/ops/pallas/poisson.py:
poisson_sweeps`` (:200; ``_sweep_kernel`` :120, arithmetic ``_sweep_math``
:69).  The TPU's wavefront (``poisson_wavefront`` :1301, psi emission) and
its in-place multisweeps (``poisson_multisweep2`` :700,
``poisson_multisweep`` :413) run the same sweeps bit-identically, so this
kernel computes their function too.  The CUDA source is
``csrc/poisson.cu``.  A call runs the sweeps as passes of k sweeps, each
one launch of a z-wavefront (the TPU's ``_wavefront_kernel`` :866
rethought for a 227 KB SM): a block holds an (x, y) tile with its halo and
walks its chunk of z with k stages one plane apart; stage 1 pulls from an
input plane that the block loads through registers a tick ahead, and each
later stage pulls from the ring of shared memory that the stage before it
fills, a ring that keeps each channel only as long as it is read.
:func:`plan` picks the pass depth, the tile and the z chunk; a remainder
pass runs ``n_iters mod k`` sweeps with the same kernel, passes alternate
two buffers so the input is never written, and the last pass also writes
psi.  A call is :func:`launches_per_call` launches.  Every product and sum
of a sweep is rounded as :func:`poisson_sweeps_plain` rounds it, so the
kernel's outputs equal the plain version's bit for bit under any plan.

Bound on an H100 (card peaks from NVIDIA's data sheet): see :func:`cost`;
bytes bound it, 0.81 ms at 256^3 for 30 sweeps.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from ...lattice import D3Q19
from ...utils.types import CellType
from ..stream import stream
from ._lib import call, check_cuda, ptr, stream_of

__all__ = [
    "PoissonPlan",
    "passes",
    "plan",
    "check_pass",
    "launches_per_call",
    "smem_bytes",
    "tile_width",
    "halo_left",
    "threads",
    "poisson_sweeps",
    "poisson_sweeps_plain",
    "sweep_cell",
    "cost",
]

TPU_KERNEL = ("lbm_ferrofluid_tpu/ops/pallas/poisson.py:200 (poisson_sweeps, B11b; also "
              "serves B7 poisson_wavefront :1301, B11a poisson_multisweep2 :700, "
              "B12 poisson_multisweep :413)")
CUDA_SOURCE = "lbm_ferrofluid_tpu_torch/csrc/poisson.cu"

_OBS = int(CellType.OBSTACLE)

#: the pass kernel's shape (csrc/poisson.cu: PP_EX, PP_MAX_K,
#: PP_EXT_HEIGHTS, PP_RING): extended tiles 32 cells wide, so a pass of k
#: sweeps computes tiles :func:`tile_width` wide and ty high with a (k -
#: 1)-row halo (stage 1's input plane holds the rows on either side); a warp
#: per input row; the extended heights ty + 2k - 2 it is built for, those of
#: :func:`plan`'s passes (9, 11, 13) and of the plans ``chip_smoke.py
#: --poisson-plans`` times; a stage ring keeps 38 floats a cell
EXT_WIDTH = 32
MAX_K = 4
EXT_HEIGHTS = (5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 18)
RING_FLOATS = 38
#: shared memory one block may use on an H100 (PP_SMEM_MAX), and the SM's
#: (228 KB, of which 1 KB is reserved for each resident block)
SMEM_BLOCK_MAX = 232_448
SMEM_SM = 233_472
#: sweeps a pass and tile height
K = 3
TY = 9


def smem_bytes(k: int, ty: int) -> int:
    """Shared memory of one pass block: 8 floats of padding, the input
    plane (19 channels of 32 x (ey + 2) cells, ey = ty + 2k - 2) and k - 1
    stage rings of 38 such channel planes, the (k + 1)-plane rhs ring of
    the extended tile (32 x ey cells), the wrapped column and row tables,
    and the (k + 1)-plane flags ring (1 byte a cell)."""
    ey = ty + 2 * (k - 1)
    p, pi = EXT_WIDTH * ey, EXT_WIDTH * (ey + 2)
    return (4 * (8 + 19 * pi + (k - 1) * RING_FLOATS * pi + (k + 1) * p + EXT_WIDTH + ey + 2)
            + (k + 1) * p)


def tile_width(k: int) -> int:
    """Cells of x a pass of ``k`` sweeps computes per block: 32 - 2k
    rounded down to a multiple of 8, so that every tile starts on a 32-byte
    sector (csrc/poisson.cu:lbm_pass_tx)."""
    return (EXT_WIDTH - 2 * k) // 8 * 8


def halo_left(k: int) -> int:
    """Columns of the extended tile left of the tile (at least k)."""
    return (EXT_WIDTH - tile_width(k)) // 2


def threads(k: int, ty: int) -> int:
    """Threads of a pass block: a warp per row of the input plane."""
    return EXT_WIDTH * (ty + 2 * k)


@dataclass(frozen=True)
class PoissonPlan:
    """How a call runs its sweeps: ``passes`` (sweeps per launch; all ``k``
    but a remainder), on tiles :func:`tile_width` wide and ``ty`` high and
    z chunks of ``lz`` planes."""

    k: int
    ty: int
    lz: int
    passes: tuple


def passes(n_iters: int, k: int = K) -> tuple:
    """Sweeps of each pass: ``k`` (all ``n_iters`` where fewer), then a
    remainder pass of ``n_iters mod k``."""
    if n_iters < 1:
        raise ValueError("poisson_sweeps needs n_iters >= 1")
    k = min(k, n_iters)
    return (k,) * (n_iters // k) + ((n_iters % k,) if n_iters % k else ())


def check_pass(k: int, ty: int) -> None:
    """Raise unless ``lbm_poisson_pass`` runs a pass of ``k`` sweeps on
    tiles ``ty`` high: 1 <= k <= ``MAX_K``, an extended height in
    ``EXT_HEIGHTS`` and at most ``SMEM_BLOCK_MAX`` of shared memory."""
    if not (1 <= k <= MAX_K and ty >= 1 and ty + 2 * (k - 1) in EXT_HEIGHTS):
        raise ValueError(f"a pass of {k} sweeps on {ty}-row tiles is outside the kernel's "
                         f"limits (k <= {MAX_K}, ty + 2k - 2 in {EXT_HEIGHTS})")
    smem = smem_bytes(k, ty)
    if smem > SMEM_BLOCK_MAX:
        raise ValueError(f"a pass of {k} sweeps on {ty}-row tiles needs {smem} B of shared "
                         f"memory, more than {SMEM_BLOCK_MAX}")


@functools.lru_cache(maxsize=None)
def plan(Z: int, Y: int, X: int, n_iters: int, sms: int) -> PoissonPlan:
    """The passes of ``n_iters`` sweeps on a Z x Y x X grid, on a card of
    ``sms`` SMs: passes of ``K`` sweeps on tiles ``TY`` high.

    The z chunk: a block (a tile and a chunk) walks lz + 2k - 2 planes,
    and the blocks run in waves of as many as the SMs hold, so lz
    minimises waves x (lz + 2k - 2); ties go to the larger lz.  Raises
    where a pass does not pass :func:`check_pass`.
    """
    if min(Z, Y, X) < 1:
        raise ValueError(f"grid {(Z, Y, X)}: every axis needs a cell")
    ps, ty = passes(n_iters), TY
    for k in set(ps):
        check_pass(k, ty)
    k = ps[0]
    # resident blocks an SM, as shared memory and the SM's 2048 threads
    # allow them
    slots = min(2048 // threads(k, ty), SMEM_SM // (smem_bytes(k, ty) + 1024)) * sms
    tiles = -(-X // tile_width(k)) * -(-Y // ty)

    def ticks(lz):
        return -(-tiles * -(-Z // lz) // slots) * (lz + 2 * k - 2)

    lz = min(sorted({-(-Z // c) for c in range(1, Z + 1)}, reverse=True), key=ticks)
    return PoissonPlan(k, ty, lz, ps)


def launches_per_call(n_iters: int, shape) -> int:
    """Launches of one :func:`poisson_sweeps` call on a grid of ``shape``
    (its last three entries are Z, Y, X): one a pass."""
    if min(shape[-3:]) < 1:
        raise ValueError(f"grid {tuple(shape[-3:])}: every axis needs a cell")
    return len(passes(n_iters))


def cost(h, magnetic_flags, rhs_scaled, *, tau, n_iters) -> tuple[int, int]:
    """(bytes, flops) that a call on these inputs must move and do.

    Bytes: h and the flags read at every cell, rhs only at non-obstacle
    cells (obstacles keep their bounced populations); h' and psi written
    at every cell.  Flops per sweep and non-obstacle cell: 18 for psi
    (17 adds, one multiply), then at tau == 1 one add for u, 19 multiplies
    and the rest-population subtraction (39 in all), otherwise also psi/tau
    and 2 multiplies and an add per channel (78); psi at obstacle cells
    (18) only in the last sweep, whose psi is returned."""
    n = magnetic_flags.numel()
    n_obs = int((magnetic_flags == _OBS).sum())
    per_cell = 39 if 1.0 / tau == 1.0 else 78
    return 161 * n - 4 * n_obs, n_iters * per_cell * (n - n_obs) + 18 * n_obs


def sweep_cell(s, is_obs, rhs_scaled, *, tau):
    """One sweep at every cell from the pulled, pre-bounce values ``s``
    [B, 19, ...], as ``_sweep_math``: psi from ``s`` in ascending q, u =
    psi/tau + rhs, out_q = (1-1/tau) s_q + w_q u (w_q u at tau == 1),
    minus psi/tau at q = 0, bounced values at obstacles.  Returns (out,
    psi); each product and sum is rounded on its own, as the kernel's
    ``lbm_poisson_cell`` rounds it."""
    lat = D3Q19
    inv_tau = 1.0 / tau
    a = 1.0 - inv_tau
    inv_1mw0 = 1.0 / (1.0 - float(lat.weights[0]))
    # [19, 1, ...]: broadcasts against [B, 19, ...] fields of any rank
    w = torch.as_tensor(lat.weights, dtype=s.dtype, device=s.device).reshape(
        lat.q, *([1] * (s.ndim - 2)))
    psi_sum = s[:, 1:2]
    for q in range(2, lat.q):
        psi_sum = psi_sum + s[:, q:q + 1]
    psi = psi_sum * inv_1mw0
    t = psi if inv_tau == 1.0 else psi * inv_tau
    u = t + rhs_scaled
    coll = w * u if a == 0.0 else a * s + w * u
    coll = torch.cat([coll[:, :1] - t, coll[:, 1:]], dim=1)
    opp = torch.as_tensor(lat.opposite, device=s.device)
    return torch.where(is_obs, s[:, opp], coll), psi


def poisson_sweeps_plain(h, magnetic_flags, rhs_scaled, *, tau, n_iters):
    """Plain PyTorch version of :func:`poisson_sweeps`: ``n_iters`` times
    the periodic pull and :func:`sweep_cell`."""
    is_obs = magnetic_flags == _OBS
    psi = None
    for _ in range(n_iters):
        h, psi = sweep_cell(stream(D3Q19, h), is_obs, rhs_scaled, tau=tau)
    return h, psi


def poisson_sweeps(h, magnetic_flags, rhs_scaled, *, tau, n_iters):
    """``n_iters`` channel-form Poisson sweeps.

    ``h``: [1, 19, Z, Y, X] float32; ``magnetic_flags``: [1, 1, Z, Y, X]
    uint8; ``rhs_scaled``: [1, 1, Z, Y, X] float32, dt * rhs * cs2 (0.5 -
    tau) dt without the channel weight.  Returns (h', psi of the last
    pre-collision state).  CPU tensors take the plain version; CUDA
    tensors launch the kernel, one launch a pass of :func:`plan`; anything
    else raises.  Inputs are not modified.
    """
    if h.device.type == "cpu":
        return poisson_sweeps_plain(h, magnetic_flags, rhs_scaled, tau=tau, n_iters=n_iters)
    B, Q, Z, Y, X = h.shape
    check_cuda("h", h, torch.float32, (1, 19, Z, Y, X))
    check_cuda("magnetic_flags", magnetic_flags, torch.uint8, (1, 1, Z, Y, X))
    check_cuda("rhs_scaled", rhs_scaled, torch.float32, (1, 1, Z, Y, X))
    pl = plan(Z, Y, X, n_iters, torch.cuda.get_device_properties(h.device).multi_processor_count)
    out = torch.empty_like(h)
    # pass i writes out when an even number of passes follows it, else tmp:
    # each pass reads what the one before it wrote, and the last writes out
    tmp = torch.empty_like(h) if len(pl.passes) > 1 else None
    psi = torch.empty_like(rhs_scaled)
    dims = (ctypes.c_int(Z), ctypes.c_int(Y), ctypes.c_int(X))
    st = stream_of(h)
    src = h
    for i, k in enumerate(pl.passes):
        after = len(pl.passes) - 1 - i
        dst = out if after % 2 == 0 else tmp
        call("lbm_poisson_pass", ptr(src), ptr(magnetic_flags), ptr(rhs_scaled), ptr(dst),
             ptr(None if after else psi), *dims, ctypes.c_int(k), ctypes.c_int(pl.ty),
             ctypes.c_int(pl.lz), ctypes.c_double(tau), st)
        poisson_sweeps.launches += 1
        src = dst
    return out, psi


poisson_sweeps.launches = 0
