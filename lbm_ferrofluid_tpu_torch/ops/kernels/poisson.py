"""B11b, serving B7, B11a and B12: channel-form magnetic Poisson sweeps.

Replaces the TPU kernel ``lbm_ferrofluid_tpu/ops/pallas/poisson.py:
poisson_sweeps`` (:200; ``_sweep_kernel`` :120, arithmetic ``_sweep_math``
:69).  The TPU's wavefront (``poisson_wavefront`` :1301, psi emission) and
its in-place multisweeps (``poisson_multisweep2`` :700,
``poisson_multisweep`` :413) run the same sweeps bit-identically, so this
kernel computes their function too.  The CUDA source is
``csrc/poisson.cu`` (the pass body in ``csrc/poisson_pass.cuh``, the
trailing stage's instances in ``csrc/poisson_trail.cu``).  A call runs the
sweeps as passes of k sweeps, each one launch of a z-wavefront (the TPU's
``_wavefront_kernel`` :866 rethought for a 227 KB SM): a block holds an
(x, y) tile with its halo and
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

A batch ``[B, 19, Z, Y, X]`` runs each pass in one launch for the B
elements, on an element's plan (the batch folded into the grid's z); each
element's bits are those of a call on it alone.  The slab form takes one
element.

h may be stored in bfloat16 (the JAX package's ``h_dtype="bfloat16"``):
the kernel's bfloat16 instance then reads and writes h, and keeps its
input plane and stage rings, in bfloat16, every sweep's outputs rounded to
nearest even as the one-sweep loop stores them, so the bits still equal
the plain version's under any plan; :func:`smem_bytes` and :func:`plan`
take the element size.

Bound on an H100 (card peaks from NVIDIA's data sheet): see :func:`cost`;
bytes bound it, 0.81 ms at 256^3 for 30 sweeps (0.43 ms in bfloat16).

The slab form (``ghosts=``: the TPU wavefront's ghost-ref mode, B7's
``ghosts=`` and ``emit_bands=``, for a z-slab of a domain decomposed along
z over ranks, ``parallel/step3d.py``) is one pass of k <= ``MAX_K``
sweeps: ``h`` holds the slab's Zl real planes, ``ghosts = (lo, hi)`` the
neighbours' G >= k nearest planes below and above ([1, 19, G, Y, X] each,
read in place: the slab is never copied into an extended array), and the
flags and rhs either the slab's own planes with ``aux_ghosts = ((flags_lo,
rhs_lo), (flags_hi, rhs_hi))``, the neighbours' GA >= G nearest planes of
each ([1, 1, GA, Y, X], uint8 and float32; the round reads the nearest G),
or the slab extended by G planes a side (the TPU kernel's contract).  The
kernel reads every part in place, so neither form is copied.  The walk covers
planes -k..Zl + k - 1 without a wrap, so the valid region shrinks a plane
a sweep and the real planes are exact after the k sweeps; only they are
written, psi with ``emit_psi``, and with ``emit_bands`` the first and last
G planes again as the bands the next exchange sends.  One launch
(``launches_slab``); its plain version sweeps the slab extended by its
bands' k nearest planes.

B7's trailing stage (``emit="hint"`` and ``emit="h2"``: the TPU wavefront's
emission of H_int = -grad(psi_sub) or of the Kelvin magnitude H2 = |h_ext +
H_int|^2, ``_wavefront_kernel`` :1150-1162 and :1203-1266) runs in the last
pass in place of the psi store (``csrc/poisson_trail.cu``), so psi never
reaches device memory and the call returns (h', H_int or H2): the obstacle
substitution, the 18-tap isotropic gradient summed in the TPU's tap order
times f32(-1/(12 dx)), and the output's x/y ring and z edge planes taken
from the nearest interior cell (:func:`trail_plain`).  That pass has the
geometry of a pass of k + 1 sweeps (:func:`trail_pass`: tiles
``tile_width(k + 1)`` wide and ty + 2k rows extended, a warp a row, the
grid's last column and row written by the tile before them, z chunks that
keep each edge plane with the plane it copies) and runs the stage one tick
behind stage k on psi and flags rings of ``TRAIL_SLOTS`` planes;
``launches_emit`` counts it.  Its
slab form takes ``clamp`` (the z clamp: 1 and Zl - 2 at the domain's true
edges, -1 and Zl where the slab has a neighbour) and G >= k + 1 band
planes, as the TPU's ``slab_clamp`` and its spare ghost plane.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from ...lattice import D3Q19
from ...utils.types import CellType, widen
from ..stream import stream
from ._lib import (STORAGE, call, check_batch, check_cuda, check_no_grad, check_slab_clamp,
                   count_launch, elem_bytes, ptr, stream_of)

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
    "cost_slab",
    "slab_plan",
    "SLAB_EXT_HEIGHTS",
    "trail_pass",
    "trail_plain",
    "emit_ok",
    "TRAIL_EXT_HEIGHTS",
    "EMITS",
]

TPU_KERNEL = ("lbm_ferrofluid_tpu/ops/pallas/poisson.py:200 (poisson_sweeps, B11b; also "
              "serves B7 poisson_wavefront :1301, B11a poisson_multisweep2 :700, "
              "B12 poisson_multisweep :413)")
#: the TPU kernel mode that the trailing stage replaces
TPU_KERNEL_EMIT = ("lbm_ferrofluid_tpu/ops/pallas/poisson.py:1301 (poisson_wavefront, B7, "
                   "emit=\"hint\" and emit=\"h2\": _wavefront_kernel :866, trailing stage "
                   ":1150-1162 and :1203-1266)")
CUDA_SOURCE = "lbm_ferrofluid_tpu_torch/csrc/poisson.cu"
#: the trailing stage's pass (the body shared in csrc/poisson_pass.cuh)
CUDA_SOURCE_EMIT = "lbm_ferrofluid_tpu_torch/csrc/poisson_trail.cu"

_OBS = int(CellType.OBSTACLE)

#: the pass kernel's shape (csrc/poisson.cu: PP_EX, PP_MAX_K,
#: PP_EXT_HEIGHTS, PP_RING): extended tiles 32 cells wide, so a pass of k
#: sweeps computes tiles :func:`tile_width` wide and ty high with a (k -
#: 1)-row halo (stage 1's input plane holds the rows on either side); a warp
#: per input row; the extended heights ty + 2k - 2 it is built for, those of
#: :func:`plan`'s passes (9, 11, 13) and of the plans ``chip_smoke.py
#: --poisson-plans`` times; a stage ring keeps 38 elements (of h's storage
#: type) a cell
EXT_WIDTH = 32
MAX_K = 4
EXT_HEIGHTS = (5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 18)
#: the extended heights of the slab form's instances (csrc/poisson.cu:
#: PP_SLAB_HEIGHTS): those of :func:`slab_plan`'s passes of k = 1..MAX_K
SLAB_EXT_HEIGHTS = (9, 11, 13, 15)
#: the extended heights of the pass kernel's batch instances (csrc/
#: poisson.cu: PP_BATCH_HEIGHTS): those of :func:`plan`'s passes (k = 1..3
#: on ``TY``-row tiles); the trailing pass's batch instances are built at
#: every ``TRAIL_EXT_HEIGHTS``
BATCH_EXT_HEIGHTS = (9, 11, 13)
RING_FLOATS = 38
#: the trailing stage's pass (csrc/poisson_trail.cu: PP_TRAIL_HEIGHTS,
#: PP_TRAIL_MAX_K): extended heights ty + 2k of its instances, on one device
#: and on a slab, and its most sweeps
TRAIL_EXT_HEIGHTS = (11, 13, 15)
TRAIL_MAX_K = 3
#: planes of the trailing stage's psi and flags rings (csrc/poisson_pass.cuh:
#: PP_TRAIL_SLOTS): the three its taps read and the one stage k fills beside
#: them
TRAIL_SLOTS = 4
#: what a call writes beside h': psi, H_int (3 channels) or H2 (1 channel)
EMITS = ("psi", "hint", "h2")
#: the 19-point isotropic gradient's taps, (z, y, x) offsets and weights,
#: summed in this order (lbm_ferrofluid_tpu/ops/pallas/stencil3d.py:47-57)
GRAD_TAPS = (
    (((0, 0, 1), 2.0), ((0, 0, -1), -2.0), ((1, 0, 1), 1.0), ((-1, 0, -1), -1.0),
     ((-1, 0, 1), 1.0), ((1, 0, -1), -1.0), ((0, 1, 1), 1.0), ((0, -1, -1), -1.0),
     ((0, -1, 1), 1.0), ((0, 1, -1), -1.0)),
    (((0, 1, 0), 2.0), ((0, -1, 0), -2.0), ((1, 1, 0), 1.0), ((-1, -1, 0), -1.0),
     ((-1, 1, 0), 1.0), ((1, -1, 0), -1.0), ((0, 1, 1), 1.0), ((0, -1, -1), -1.0),
     ((0, 1, -1), 1.0), ((0, -1, 1), -1.0)),
    (((1, 0, 0), 2.0), ((-1, 0, 0), -2.0), ((1, 1, 0), 1.0), ((-1, -1, 0), -1.0),
     ((1, -1, 0), 1.0), ((-1, 1, 0), -1.0), ((1, 0, 1), 1.0), ((-1, 0, -1), -1.0),
     ((1, 0, -1), 1.0), ((-1, 0, 1), -1.0)),
)
#: shared memory one block may use on an H100 (PP_SMEM_MAX), and the SM's
#: (228 KB, of which 1 KB is reserved for each resident block)
SMEM_BLOCK_MAX = 232_448
SMEM_SM = 233_472
#: sweeps a pass and tile height
K = 3
TY = 9


def smem_bytes(k: int, ty: int, elem: int = 4, trail: bool = False) -> int:
    """Shared memory of one pass block with h stored in ``elem``-byte
    elements (4: float32, 2: bfloat16): 8 elements of padding, the input
    plane (19 channels of 32 x (ey + 2) cells, ey = ty + 2k - 2, or ty + 2k
    with the trailing stage) and k - 1 stage rings of 38 such channel
    planes, all in h's storage type; then the (k + 1)-plane float32 rhs
    ring of the extended tile (32 x ey cells), the wrapped column and row
    tables, and the (k + 1)-plane flags ring (1 byte a cell); with
    ``trail`` the final sweep's psi (float32) and obstacle flags (1 byte) of
    ``TRAIL_SLOTS`` planes."""
    ey = ty + 2 * (k - 1) + 2 * trail
    p, pi = EXT_WIDTH * ey, EXT_WIDTH * (ey + 2)
    return (elem * (8 + 19 * pi + (k - 1) * RING_FLOATS * pi)
            + 4 * ((k + 1) * p + EXT_WIDTH + ey + 2) + (k + 1) * p + 5 * TRAIL_SLOTS * p * trail)


def tile_width(k: int) -> int:
    """Cells of x a pass of ``k`` sweeps computes per block: 32 - 2k
    rounded down to a multiple of 8, so that every tile starts on a 32-byte
    sector (csrc/poisson.cu:lbm_pass_tx)."""
    return (EXT_WIDTH - 2 * k) // 8 * 8


def halo_left(k: int) -> int:
    """Columns of the extended tile left of the tile (at least k)."""
    return (EXT_WIDTH - tile_width(k)) // 2


def threads(k: int, ty: int) -> int:
    """Threads of a pass block of k sweeps: a warp per row of the input
    plane (ty + 2k rows); of the trailing stage's pass of k sweeps too: a
    warp per row of its ty + 2k extended rows."""
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


def check_pass(k: int, ty: int, elem: int = 4) -> None:
    """Raise unless ``lbm_poisson_pass`` runs a pass of ``k`` sweeps on
    tiles ``ty`` high with h in ``elem``-byte elements: 1 <= k <=
    ``MAX_K``, an extended height in ``EXT_HEIGHTS`` and at most
    ``SMEM_BLOCK_MAX`` of shared memory."""
    if not (1 <= k <= MAX_K and ty >= 1 and ty + 2 * (k - 1) in EXT_HEIGHTS):
        raise ValueError(f"a pass of {k} sweeps on {ty}-row tiles is outside the kernel's "
                         f"limits (k <= {MAX_K}, ty + 2k - 2 in {EXT_HEIGHTS})")
    smem = smem_bytes(k, ty, elem)
    if smem > SMEM_BLOCK_MAX:
        raise ValueError(f"a pass of {k} sweeps on {ty}-row tiles needs {smem} B of shared "
                         f"memory, more than {SMEM_BLOCK_MAX}")


def _chunk(Z: int, Y: int, X: int, k: int, ty: int, sms: int, elem: int,
           trail: bool = False) -> int:
    """The z chunk of a pass: a block (a tile and a chunk) walks lz + 2k -
    2 planes, and the blocks run in waves of as many as the SMs hold, so
    lz minimises waves x (lz + 2k - 2); ties go to the larger lz.  The
    trailing stage's pass walks lz + 2k planes on the tiles of a pass of
    k + 1 sweeps, and its chunks hold 2 planes or more, the last one too, so
    that each z edge plane lies in the chunk of the plane it copies."""
    kg = k + trail
    # resident blocks an SM, as shared memory and the SM's 2048 threads
    # allow them
    slots = min(2048 // threads(k, ty),
                SMEM_SM // (smem_bytes(k, ty, elem, trail) + 1024)) * sms
    tiles = -(-(X - trail) // tile_width(kg)) * -(-(Y - trail) // ty)

    def ticks(lz):
        return -(-tiles * -(-Z // lz) // slots) * (lz + 2 * kg - 2)

    lzs = sorted({-(-Z // c) for c in range(1, Z + 1)}, reverse=True)
    if trail:
        lzs = [lz for lz in lzs if lz == Z or (lz >= 2 and Z % lz != 1)]
    return min(lzs, key=ticks)


@functools.lru_cache(maxsize=None)
def plan(Z: int, Y: int, X: int, n_iters: int, sms: int, elem: int = 4) -> PoissonPlan:
    """The passes of ``n_iters`` sweeps on a Z x Y x X grid, on a card of
    ``sms`` SMs, with h in ``elem``-byte elements: passes of ``K`` sweeps on
    tiles ``TY`` high, z chunks by :func:`_chunk`.  Raises where a pass
    does not pass :func:`check_pass`.
    """
    if min(Z, Y, X) < 1:
        raise ValueError(f"grid {(Z, Y, X)}: every axis needs a cell")
    ps, ty = passes(n_iters), TY
    for k in set(ps):
        check_pass(k, ty, elem)
    return PoissonPlan(ps[0], ty, _chunk(Z, Y, X, ps[0], ty, sms, elem), ps)


@functools.lru_cache(maxsize=None)
def trail_pass(Z: int, Y: int, X: int, k: int, sms: int, elem: int = 4) -> PoissonPlan:
    """The last pass of a call with the trailing stage, k sweeps on a grid
    (or slab) of Z x Y x X: tiles ``TY`` high on the geometry of a pass of
    k + 1 sweeps, z chunks by :func:`_chunk`.  Raises where the kernel has
    no such instance (k <= ``TRAIL_MAX_K``, ty + 2k in ``TRAIL_EXT_HEIGHTS``)
    or its block does not fit the shared memory."""
    ty = TY
    if not (1 <= k <= TRAIL_MAX_K and ty + 2 * k in TRAIL_EXT_HEIGHTS):
        raise ValueError(f"the trailing stage's pass runs 1 <= k <= {TRAIL_MAX_K} sweeps, "
                         f"got {k}")
    smem = smem_bytes(k, ty, elem, trail=True)
    if smem > SMEM_BLOCK_MAX:
        raise ValueError(f"the trailing stage's pass of {k} sweeps needs {smem} B of shared "
                         f"memory, more than {SMEM_BLOCK_MAX}")
    return PoissonPlan(k, ty, _chunk(Z, Y, X, k, ty, sms, elem, trail=True), (k,))


def launches_per_call(n_iters: int, shape) -> int:
    """Launches of one :func:`poisson_sweeps` call on a grid of ``shape``
    (its last three entries are Z, Y, X): one a pass."""
    if min(shape[-3:]) < 1:
        raise ValueError(f"grid {tuple(shape[-3:])}: every axis needs a cell")
    return len(passes(n_iters))


#: float32 channels a call writes beside h', by ``emit``
EMIT_CHANNELS = {"psi": 1, "hint": 3, "h2": 1}


def _trail_flops(interior: int, emit: str, h_ext) -> int:
    """Flops of the trailing stage at ``interior`` source cells: 33 for the
    gradient (10 weighted taps a component and its scale); for H2 an add
    a nonzero field component, 3 squares and 2 adds."""
    if emit == "psi":
        return 0
    return interior * (33 + (5 + sum(1 for c in h_ext if c) if emit == "h2" else 0))


def cost(h, magnetic_flags, rhs_scaled, *, tau, n_iters, emit="psi", h_ext=None,
         **_) -> tuple[int, int]:
    """(bytes, flops) that a call on these inputs must move and do.

    Bytes: h (in its storage type) and the flags read at every cell, rhs
    only at non-obstacle cells (obstacles keep their bounced populations);
    h' and psi (H_int's 3 channels, or H2, by ``emit``) written at every
    cell.  Flops per sweep and non-obstacle cell: 18 for psi
    (17 adds, one multiply), then at tau == 1 one add for u, 19 multiplies
    and the rest-population subtraction (39 in all), otherwise also psi/tau
    and 2 multiplies and an add per channel (78); psi at obstacle cells
    (18) only in the last sweep, whose psi is returned or differentiated;
    the trailing stage's at the interior cells (:func:`_trail_flops`).  Each
    of the B elements of a batch counts."""
    n = magnetic_flags.numel()
    n_obs = int((magnetic_flags == _OBS).sum())
    per_cell = 39 if 1.0 / tau == 1.0 else 78
    h_bytes = 19 * elem_bytes(h)
    B, _, Z, Y, X = h.shape
    interior = B * max(Z - 2, 1) * (Y - 2) * (X - 2)
    return ((2 * h_bytes + 5 + 4 * EMIT_CHANNELS[emit]) * n - 4 * n_obs,
            n_iters * per_cell * (n - n_obs) + 18 * n_obs + _trail_flops(interior, emit, h_ext))


def cost_slab(h, magnetic_flags, rhs_scaled, *, tau, n_iters, rounds, G, emit="psi",
              h_ext=None, clamp=None, **_) -> tuple[int, int]:
    """(bytes, flops) that a slab solve of ``n_iters`` sweeps in ``rounds``
    (the sweeps of each launch, G band planes a side; flags and rhs with
    bands of G planes) must move and do, as :func:`cost` counts one
    device's call: h's real planes read and written once, psi (H_int, H2)
    written once, the flags and rhs of the Zl + 2G planes read once, and the bands
    each round reads (the first round's from the incoming h), which the
    round before it writes; the sweeps' flops over the planes each sweep of
    a round's shrinking region computes (Zl + 2(k - j) at its sweep j), 78
    or 39 a cell by tau.  With the trailing stage (``emit``, ``clamp``)
    the last round reads G_f = k_f + 1 band planes a side of h (the round
    before it writes none), the flags' and rhs' bands hold max(G, G_f)
    planes, the last round's sweeps reach one plane further a side, and the stage's
    flops count the planes its clamp computes."""
    _, _, Zl, Y, X = h.shape
    plane = Y * X
    h_bytes = 19 * elem_bytes(h)
    per_cell = 39 if 1.0 / tau == 1.0 else 78
    reach = [0] * len(rounds)
    if emit == "psi":
        bands = 2 * G * h_bytes * plane * (2 * len(rounds) - 1)
        G_ext = G
        trail = 0
    else:
        G_f = rounds[-1] + 1
        written = max(len(rounds) - 2, 0)
        bands = 2 * h_bytes * plane * (G * (len(rounds) - 1 + written) + G_f)
        G_ext = max(G, G_f)
        reach[-1] = 1
        planes = Zl - (clamp[0] > 0) - (clamp[1] < Zl)
        trail = _trail_flops(planes * (Y - 2) * (X - 2), emit, h_ext)
    nbytes = ((2 * h_bytes + 4 * EMIT_CHANNELS[emit]) * Zl * plane + 5 * (Zl + 2 * G_ext) * plane
              + bands)
    return nbytes, per_cell * plane * sum(Zl + 2 * (k - j + d) for k, d in zip(rounds, reach)
                                          for j in range(1, k + 1)) + trail


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


def trail_plain(psi, magnetic_flags, *, dx, h_ext=None, emit="h2", clamp, out=None):
    """The trailing stage's plain version: H_int [1, 3, ...] (``emit="hint"``)
    or H2 [1, 1, ...] (``emit="h2"``, ``h_ext`` the constant field) of the
    output planes ``out = (o0, o1)`` (default all) of psi [1, 1, Zp, Y, X]
    and the magnetic flags of the same planes, as the TPU wavefront's
    trailing stage computes them: at each cell the value at its source, the
    interior cell nearest to it (z clamped to ``clamp = (zlo, zhi)``, x and y
    to the interior), which is the stage's ring replication of its output;
    there the 10 taps of ``GRAD_TAPS`` of each component, on psi with its
    magnetic obstacles substituted (psi of the nearest interior cell, z
    clamped the same), each weighted and summed in the TPU's order, times
    f32(-1/(12 dx)); for H2 the field added to each nonzero component and
    the squares summed in channel order (``ops/magnetic.py:maybe_h2``).
    The source planes' neighbours must lie inside psi's planes."""
    from ..magnetic import maybe_h2

    _, _, Zp, Y, X = psi.shape
    zlo, zhi = clamp
    o0, o1 = out or (0, Zp)
    dev = psi.device
    zi = torch.clamp(torch.arange(Zp, device=dev), zlo, zhi)
    yi = torch.clamp(torch.arange(Y, device=dev), 1, Y - 2)
    xi = torch.clamp(torch.arange(X, device=dev), 1, X - 2)
    rep = psi.index_select(2, zi).index_select(3, yi).index_select(4, xi)
    sub = torch.where(magnetic_flags == _OBS, rep, psi)
    s0, s1 = min(max(o0, zlo), zhi), min(max(o1 - 1, zlo), zhi)
    if s0 < 1 or s1 > Zp - 2:
        raise ValueError(f"trail_plain: source planes {s0}..{s1} need psi one plane past them "
                         f"in {Zp} planes")

    def S(oz, oy, ox):
        return sub[:, :, s0 + oz:s1 + 1 + oz, 1 + oy:Y - 1 + oy, 1 + ox:X - 1 + ox]

    m = torch.tensor(-1.0 / (12.0 * dx), dtype=psi.dtype, device=dev)
    comps = []
    for taps in GRAD_TAPS:
        acc = None
        for off, w in taps:
            tp = S(*off) * w
            acc = tp if acc is None else acc + tp
        comps.append(acc * m)
    H = torch.cat(comps, dim=1)
    if emit == "h2":
        H = maybe_h2(H, h_ext)
    zo = torch.clamp(torch.arange(o0, o1, device=dev), zlo, zhi) - s0
    return H.index_select(2, zo).index_select(3, yi - 1).index_select(4, xi - 1).contiguous()


def emit_ok(shape, slab=False) -> bool:
    """Can a call on an h of ``shape`` ([.., Z, Y, X]; with ``slab`` a
    slab's) emit H_int or H2: an interior cell in x and y (Y, X >= 3) and,
    on one device, in z (Z >= 3; a slab's clamp is checked on its own)."""
    Z, Y, X = shape[-3:]
    return min(Y, X) >= 3 and (slab or Z >= 3)


def _check_emit(h, ghosts, emit, n_iters, h_ext, clamp, emit_bands):
    """Raise unless the call's emission is one this function takes: psi, or
    H_int or H2 on a grid :func:`emit_ok` admits, H2 with a 3-component
    field, on a slab with ``clamp``, G >= k + 1 band planes and no bands."""
    if emit not in EMITS:
        raise ValueError(f"poisson_sweeps emits one of {EMITS}, not {emit!r}")
    if emit == "psi":
        if clamp is not None:
            raise ValueError("poisson_sweeps: clamp is the trailing stage's (emit='hint' or 'h2')")
        return
    if (ghosts is None) == (clamp is not None) or emit_bands:
        raise ValueError("poisson_sweeps: the trailing stage takes clamp on a slab (and no "
                         "emit_bands), none on one device")
    if emit == "h2" and (h_ext is None or len(h_ext) != 3):
        raise ValueError("emit='h2' needs the 3-component constant field h_ext")
    if ghosts is not None:
        check_slab_clamp("poisson_sweeps", clamp, h.shape[2], 2)
        if ghosts[0].shape[2] < n_iters + 1:
            raise ValueError(f"the trailing stage on a slab needs G >= k + 1 = {n_iters + 1} "
                             f"band planes, got {ghosts[0].shape[2]}")
    if not emit_ok(h.shape, slab=ghosts is not None):
        raise ValueError(f"emit={emit!r} needs Y, X >= 3 and Z >= 3 on one device, got "
                         f"{tuple(h.shape[2:])}")


def poisson_sweeps_plain(h, magnetic_flags, rhs_scaled, *, tau, n_iters, ghosts=None,
                         emit_bands=False, emit_psi=True, emit="psi", dx=1.0, h_ext=None,
                         clamp=None, aux_ghosts=None):
    """Plain PyTorch version of :func:`poisson_sweeps`: ``n_iters`` times
    the periodic pull and :func:`sweep_cell`, each sweep's output stored in
    h's dtype (a bfloat16 h is widened to float32 for the sweep and its
    output rounded back, as the TPU kernel stores every sweep); psi is
    float32 (float64 for a float64 h).  The slab form sweeps the slab
    extended by the k nearest planes of each band (and of the extended
    flags and rhs), whose wrap reaches no real plane in k sweeps, and keeps
    the real planes; with the trailing stage by k + 1 planes, so psi is
    exact a plane past the slab, and H_int or H2 comes from
    :func:`trail_plain` of the slab's psi and one plane a side.  With
    ``aux_ghosts`` the flags and rhs are first extended by the nearest G
    planes of their bands."""
    _check_emit(h, ghosts, emit, n_iters, h_ext, clamp, emit_bands)
    trail = emit != "psi"
    if ghosts is not None:
        k, G = n_iters, ghosts[0].shape[2]
        Zl = h.shape[2]
        GA = _aux_depth(h, magnetic_flags, rhs_scaled, G, aux_ghosts)
        if aux_ghosts is not None:
            magnetic_flags, rhs_scaled = (
                torch.cat([lo[:, :, GA - G:], x, hi[:, :, :G]], dim=2)
                for x, lo, hi in zip((magnetic_flags, rhs_scaled), *aux_ghosts, strict=True))
        w = k + trail
        ext = slice(G - w, G + Zl + w)
        he, psi = poisson_sweeps_plain(
            torch.cat([ghosts[0][:, :, G - w:], h, ghosts[1][:, :, :w]], dim=2),
            magnetic_flags[:, :, ext], rhs_scaled[:, :, ext], tau=tau, n_iters=k)
        h = he[:, :, w:w + Zl].contiguous()
        if trail:
            aux = trail_plain(psi[:, :, k:k + Zl + 2], magnetic_flags[:, :, G - 1:G + Zl + 1],
                              dx=dx, h_ext=h_ext, emit=emit,
                              clamp=(clamp[0] + 1, clamp[1] + 1), out=(1, Zl + 1))
        else:
            aux = psi[:, :, w:w + Zl].contiguous() if emit_psi else None
        return (h, aux) + ((h[:, :, :G].contiguous(), h[:, :, -G:].contiguous()),) * emit_bands
    is_obs = magnetic_flags == _OBS
    psi = None
    for _ in range(n_iters):
        out, psi = sweep_cell(widen(stream(D3Q19, h)), is_obs, rhs_scaled, tau=tau)
        h = out.to(h.dtype)
    if trail:
        return h, trail_plain(psi, magnetic_flags, dx=dx, h_ext=h_ext, emit=emit,
                              clamp=(1, h.shape[2] - 2))
    return h, psi


def _flags_rhs_parts(magnetic_flags, rhs_scaled, G, Zl, aux_ghosts):
    """The slab form's flags and rhs as (name, tensor, dtype, planes): the
    extended pair of Zl + 2G planes, or the slab's planes and, with
    ``aux_ghosts``, the bands of each side."""
    if aux_ghosts is None:
        return [("magnetic_flags", magnetic_flags, torch.uint8, Zl + 2 * G),
                ("rhs_scaled", rhs_scaled, torch.float32, Zl + 2 * G)]
    if len(aux_ghosts) != 2 or not all(isinstance(side, (tuple, list)) and len(side) == 2
                                       for side in aux_ghosts):
        raise ValueError("poisson_sweeps: aux_ghosts takes a (flags, rhs) pair a side, "
                         "((flags_lo, rhs_lo), (flags_hi, rhs_hi))")
    GA = aux_ghosts[0][0].shape[2]
    return [("magnetic_flags", magnetic_flags, torch.uint8, Zl),
            ("rhs_scaled", rhs_scaled, torch.float32, Zl)] + [
        (f"{name}_{side}", t, dtype, GA) for side, pair in zip(("lo", "hi"), aux_ghosts)
        for name, t, dtype in zip(("flags", "rhs"), pair, (torch.uint8, torch.float32))]


def _aux_depth(h, magnetic_flags, rhs_scaled, G, aux_ghosts):
    """GA, the planes of the slab form's flags and rhs bands (G for the
    extended pair), once their dtypes and shapes hold: every band of GA >=
    G planes, the flags uint8 and the rhs float32."""
    _, _, Zl, Y, X = h.shape
    parts = _flags_rhs_parts(magnetic_flags, rhs_scaled, G, Zl, aux_ghosts)
    for name, t, dtype, planes in parts:
        if t.dtype != dtype or tuple(t.shape) != (1, 1, planes, Y, X):
            raise ValueError(f"poisson_sweeps' slab form: {name} must be {dtype} of shape "
                             f"{(1, 1, planes, Y, X)}, got {t.dtype} of {tuple(t.shape)}")
    GA = G if aux_ghosts is None else parts[-1][3]
    if GA < G:
        raise ValueError(f"poisson_sweeps' slab form: the flags and rhs bands hold {GA} planes, "
                         f"fewer than the G = {G} planes of h's bands")
    return GA


def _check_slab(h, magnetic_flags, rhs_scaled, ghosts, n_iters, aux_ghosts=None):
    """Raise unless the slab form takes these inputs; returns (G, GA)."""
    _, _, Zl, Y, X = h.shape
    G = ghosts[0].shape[2]
    if not 1 <= n_iters <= min(MAX_K, G) or G > Zl:
        raise ValueError(f"poisson_sweeps' slab form runs one pass of 1 <= k <= G <= Zl sweeps "
                         f"(k <= {MAX_K}), got k = {n_iters}, G = {G}, Zl = {Zl}")
    for name, t in zip(("ghost_lo", "ghost_hi"), ghosts, strict=True):
        check_cuda(name, t, (h.dtype,), (1, 19, G, Y, X))
    GA = _aux_depth(h, magnetic_flags, rhs_scaled, G, aux_ghosts)
    for name, t, dtype, planes in _flags_rhs_parts(magnetic_flags, rhs_scaled, G, Zl,
                                                   aux_ghosts):
        check_cuda(name, t, dtype, (1, 1, planes, Y, X))
    return G, GA


def _flags_rhs_ptrs(magnetic_flags, rhs_scaled, G, Zl, aux_ghosts):
    """The C entry point's flags, rhs, flo, fhi, rlo, rhi: the slab's
    planes and their bands, or the extended pair's planes [G, G + Zl) and
    the G planes either side of them, in place."""
    if aux_ghosts is not None:
        (flo, rlo), (fhi, rhi) = aux_ghosts
        return tuple(ptr(t) for t in (magnetic_flags, rhs_scaled, flo, fhi, rlo, rhi))
    plane = magnetic_flags.shape[-1] * magnetic_flags.shape[-2]
    f, r = magnetic_flags.data_ptr(), rhs_scaled.data_ptr()
    return tuple(ctypes.c_void_p(a) for a in (f + G * plane, r + 4 * G * plane, f,
                                               f + (G + Zl) * plane, r,
                                               r + 4 * (G + Zl) * plane))


@functools.lru_cache(maxsize=None)
def slab_plan(Zl: int, Y: int, X: int, k: int, sms: int, elem: int = 4) -> PoissonPlan:
    """The one pass of k sweeps of the slab form on a slab of Zl planes:
    tiles ``TY`` high, or where that block does not fit the shared memory
    the tallest below it among ``SLAB_EXT_HEIGHTS`` that does (k = 4 in
    float32: 5 rows), z chunks by :func:`_chunk`.  Raises where no height
    fits."""
    if min(Zl, Y, X) < 1:
        raise ValueError(f"grid {(Zl, Y, X)}: every axis needs a cell")
    fits = [ty for ty in range(TY, 0, -1) if ty + 2 * (k - 1) in SLAB_EXT_HEIGHTS
            and smem_bytes(k, ty, elem) <= SMEM_BLOCK_MAX]
    if not fits:
        raise ValueError(f"no slab pass of {k} sweeps fits: the slab form is built for "
                         f"extended heights {SLAB_EXT_HEIGHTS} within {SMEM_BLOCK_MAX} B")
    return PoissonPlan(k, fits[0], _chunk(Zl, Y, X, k, fits[0], sms, elem), (k,))


def _trail_args(emit, dx, h_ext, clamp):
    """The C entry point's trailing-stage arguments: mode (0 none, 1 H_int,
    2 H2), the z clamp, dx and the field."""
    hx = tuple(float(v) for v in (h_ext or (0.0, 0.0, 0.0)))
    return (ctypes.c_int(EMITS.index(emit)), *(ctypes.c_int(v) for v in clamp),
            ctypes.c_double(dx), *(ctypes.c_double(v) for v in hx))


def poisson_sweeps(h, magnetic_flags, rhs_scaled, *, tau, n_iters, ghosts=None,
                   emit_bands=False, emit_psi=True, emit="psi", dx=1.0, h_ext=None, clamp=None,
                   aux_ghosts=None):
    """``n_iters`` channel-form Poisson sweeps.

    ``h``: [B, 19, Z, Y, X] float32 or bfloat16; ``magnetic_flags``: [B, 1, Z, Y, X]
    uint8; ``rhs_scaled``: [B, 1, Z, Y, X] float32, dt * rhs * cs2 (0.5 -
    tau) dt without the channel weight.  Returns (h', psi of the last
    pre-collision state), or with ``emit="hint"`` (h', H_int [B, 3, Z, Y,
    X]) and with ``emit="h2"`` (h', H2 [B, 1, Z, Y, X]) of the constant
    field ``h_ext``, both with the gradient's ``dx`` (the trailing stage,
    module docstring).  The B elements of a batch run in each launch, on
    an element's plan.  With ``ghosts`` the slab form (module docstring, B = 1),
    flags and rhs extended by G planes a side, or the slab's with their
    bands ``aux_ghosts``: returns (h', psi or None
    without ``emit_psi``, or H_int or H2 with ``clamp``) and with
    ``emit_bands`` also (band_lo, band_hi).  CPU tensors take the plain
    version; CUDA tensors launch the kernel, one launch a pass of
    :func:`plan` (the last one :func:`trail_pass` with the trailing stage;
    the slab form one launch); anything else raises.  Inputs are not
    modified.
    """
    if ghosts is None and (emit_bands or not emit_psi or aux_ghosts is not None):
        raise ValueError("poisson_sweeps: emit_bands, emit_psi=False and aux_ghosts are the "
                         "slab form's")
    if h.device.type == "cpu":
        return poisson_sweeps_plain(h, magnetic_flags, rhs_scaled, tau=tau, n_iters=n_iters,
                                    ghosts=ghosts, emit_bands=emit_bands, emit_psi=emit_psi,
                                    emit=emit, dx=dx, h_ext=h_ext, clamp=clamp,
                                    aux_ghosts=aux_ghosts)
    check_no_grad("poisson_sweeps", h, rhs_scaled)
    _check_emit(h, ghosts, emit, n_iters, h_ext, clamp, emit_bands)
    if ghosts is not None:
        return _sweeps_slab(h, magnetic_flags, rhs_scaled, ghosts, tau, n_iters, emit_bands,
                            emit_psi, emit, dx, h_ext, clamp, aux_ghosts)
    B, Q, Z, Y, X = h.shape
    check_cuda("h", h, STORAGE, (B, 19, Z, Y, X))
    check_cuda("magnetic_flags", magnetic_flags, torch.uint8, (B, 1, Z, Y, X))
    check_cuda("rhs_scaled", rhs_scaled, torch.float32, (B, 1, Z, Y, X))
    bf16 = h.dtype == torch.bfloat16
    sms = torch.cuda.get_device_properties(h.device).multi_processor_count
    pl = plan(Z, Y, X, n_iters, sms, elem_bytes(h))
    last = trail_pass(Z, Y, X, pl.passes[-1], sms, elem_bytes(h)) if emit != "psi" else pl
    check_batch("poisson_sweeps", B, zblocks=-(-Z // min(pl.lz, last.lz)))
    out = torch.empty_like(h)
    # pass i writes out when an even number of passes follows it, else tmp:
    # each pass reads what the one before it wrote, and the last writes out
    tmp = torch.empty_like(h) if len(pl.passes) > 1 else None
    aux = torch.empty((B, EMIT_CHANNELS[emit], Z, Y, X), dtype=torch.float32, device=h.device)
    dims = (ctypes.c_int(B), ctypes.c_int(Z), ctypes.c_int(Y), ctypes.c_int(X))
    st = stream_of(h)
    src = h
    for i, k in enumerate(pl.passes):
        after = len(pl.passes) - 1 - i
        dst = out if after % 2 == 0 else tmp
        mode = "psi" if after else emit
        tile = last if not after else pl
        call("lbm_poisson_pass", ptr(src), ptr(magnetic_flags), ptr(rhs_scaled), ptr(dst),
             ptr(None if after else aux), *dims, ctypes.c_int(k), ctypes.c_int(tile.ty),
             ctypes.c_int(tile.lz), ctypes.c_double(tau), ctypes.c_int(bf16), ptr(None),
             ptr(None), ctypes.c_int(0), ptr(None), ptr(None), *(ptr(None),) * 4,
             ctypes.c_int(0), *_trail_args(mode, dx, h_ext, (1, Z - 2)), st)
        count_launch(poisson_sweeps, bf16, "emit" if mode != "psi" else None, B)
        src = dst
    return out, aux


def _sweeps_slab(h, magnetic_flags, rhs_scaled, ghosts, tau, k, emit_bands, emit_psi, emit, dx,
                 h_ext, clamp, aux_ghosts):
    """The slab form's one launch (:func:`poisson_sweeps`)."""
    B, Q, Zl, Y, X = h.shape
    check_batch("poisson_sweeps", B, slab=True)
    check_cuda("h", h, STORAGE, (1, 19, Zl, Y, X))
    G, GA = _check_slab(h, magnetic_flags, rhs_scaled, ghosts, k, aux_ghosts)
    flags, rhs, *bands_in = _flags_rhs_ptrs(magnetic_flags, rhs_scaled, G, Zl, aux_ghosts)
    bf16 = h.dtype == torch.bfloat16
    sms = torch.cuda.get_device_properties(h.device).multi_processor_count
    if emit == "psi":
        pl = slab_plan(Zl, Y, X, k, sms, elem_bytes(h))
    else:
        pl = trail_pass(Zl, Y, X, k, sms, elem_bytes(h))
    out = torch.empty_like(h)
    aux = (torch.empty((1, EMIT_CHANNELS[emit], Zl, Y, X), dtype=torch.float32, device=h.device)
           if emit_psi or emit != "psi" else None)
    bands = tuple(torch.empty_like(ghosts[0]) for _ in range(2)) if emit_bands else (None, None)
    call("lbm_poisson_pass", ptr(h), flags, rhs, ptr(out), ptr(aux), ctypes.c_int(1),
         ctypes.c_int(Zl), ctypes.c_int(Y), ctypes.c_int(X), ctypes.c_int(k),
         ctypes.c_int(pl.ty), ctypes.c_int(pl.lz), ctypes.c_double(tau), ctypes.c_int(bf16),
         ptr(ghosts[0]), ptr(ghosts[1]), ctypes.c_int(G), ptr(bands[0]), ptr(bands[1]),
         *bands_in, ctypes.c_int(GA), *_trail_args(emit, dx, h_ext, clamp or (1, Zl - 2)),
         stream_of(h))
    count_launch(poisson_sweeps, bf16, ("slab", "emit") if emit != "psi" else "slab")
    return (out, aux, bands) if emit_bands else (out, aux)


poisson_sweeps.launches = 0
poisson_sweeps.launches_bf16 = 0
poisson_sweeps.launches_slab = 0
poisson_sweeps.launches_emit = 0
poisson_sweeps.launches_batch = 0
