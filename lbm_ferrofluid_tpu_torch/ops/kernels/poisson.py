"""B11b, serving B7, B11a and B12: channel-form magnetic Poisson sweeps.

Replaces the TPU kernel ``lbm_ferrofluid_tpu/ops/pallas/poisson.py:
poisson_sweeps`` (:200; ``_sweep_kernel`` :120, arithmetic ``_sweep_math``
:69).  The TPU's wavefront (``poisson_wavefront`` :1301, psi emission) and
its in-place multisweeps (``poisson_multisweep2`` :700,
``poisson_multisweep`` :413) run the same sweeps bit-identically, so this
kernel computes their function too.  The CUDA source is
``csrc/poisson.cu``: one launch per sweep over the volume (periodic pull on
all three axes, bounce-back at magnetic obstacles, psi summed before the
bounce, the Chai relaxation in ``_sweep_math``'s reduced form with its
tau == 1 specialisation), alternating two buffers because a sweep reads 18
neighbours of every channel; the last sweep writes the output and psi.  A
call is ``n_iters`` launches.

Bound on an H100 (card peaks from NVIDIA's data sheet): see :func:`cost`;
bytes bound it, 0.81 ms at 256^3 for 30 sweeps.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ...lattice import D3Q19
from ...utils.types import CellType
from ..stream import stream
from ._lib import call, check_cuda, ptr, stream_of

__all__ = ["poisson_sweeps", "poisson_sweeps_plain", "cost"]

TPU_KERNEL = ("lbm_ferrofluid_tpu/ops/pallas/poisson.py:200 (poisson_sweeps, B11b; also "
              "serves B7 poisson_wavefront :1301, B11a poisson_multisweep2 :700, "
              "B12 poisson_multisweep :413)")
CUDA_SOURCE = "lbm_ferrofluid_tpu_torch/csrc/poisson.cu"

_OBS = int(CellType.OBSTACLE)


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


def poisson_sweeps_plain(h, magnetic_flags, rhs_scaled, *, tau, n_iters):
    """Plain PyTorch version of :func:`poisson_sweeps`, step by step as
    ``_sweep_math``: psi from the pre-bounce streamed values in ascending
    q, u = psi/tau + rhs, out_q = (1-1/tau) streamed_q + w_q u (w_q u at
    tau == 1), minus psi/tau at q = 0, bounced values at obstacles."""
    lat = D3Q19
    inv_tau = 1.0 / tau
    a = 1.0 - inv_tau
    inv_1mw0 = 1.0 / (1.0 - float(lat.weights[0]))
    w = torch.as_tensor(lat.w_bcast(np.float64), dtype=h.dtype, device=h.device)
    opp = torch.as_tensor(lat.opposite, device=h.device)
    is_obs = magnetic_flags == _OBS
    psi = None
    for _ in range(n_iters):
        s = stream(lat, h)
        psi_sum = s[:, 1:2]
        for q in range(2, lat.q):
            psi_sum = psi_sum + s[:, q:q + 1]
        psi = psi_sum * inv_1mw0
        t = psi if inv_tau == 1.0 else psi * inv_tau
        u = t + rhs_scaled
        coll = w * u if a == 0.0 else a * s + w * u
        coll = torch.cat([coll[:, :1] - t, coll[:, 1:]], dim=1)
        h = torch.where(is_obs, s[:, opp], coll)
    return h, psi


def poisson_sweeps(h, magnetic_flags, rhs_scaled, *, tau, n_iters):
    """``n_iters`` channel-form Poisson sweeps.

    ``h``: [1, 19, Z, Y, X] float32; ``magnetic_flags``: [1, 1, Z, Y, X]
    uint8; ``rhs_scaled``: [1, 1, Z, Y, X] float32, dt * rhs * cs2 (0.5 -
    tau) dt without the channel weight.  Returns (h', psi of the last
    pre-collision state).  CPU tensors take the plain version; CUDA
    tensors launch the kernel; anything else raises.  Inputs are not
    modified.
    """
    if h.device.type == "cpu":
        return poisson_sweeps_plain(h, magnetic_flags, rhs_scaled, tau=tau, n_iters=n_iters)
    B, Q, Z, Y, X = h.shape
    check_cuda("h", h, torch.float32, (1, 19, Z, Y, X))
    check_cuda("magnetic_flags", magnetic_flags, torch.uint8, (1, 1, Z, Y, X))
    check_cuda("rhs_scaled", rhs_scaled, torch.float32, (1, 1, Z, Y, X))
    if n_iters < 1:
        raise ValueError("poisson_sweeps needs n_iters >= 1")
    out = torch.empty_like(h)
    spare = torch.empty_like(h) if n_iters > 1 else None
    psi = torch.empty_like(rhs_scaled)
    dims = (ctypes.c_int(Z), ctypes.c_int(Y), ctypes.c_int(X))
    st = stream_of(h)
    src = h
    # counting back from the last sweep, sweeps alternate between out and
    # spare, so no sweep writes the buffer it reads and h stays untouched
    for k in range(1, n_iters + 1):
        dst = out if (n_iters - k) % 2 == 0 else spare
        call("lbm_poisson_sweep", ptr(src), ptr(magnetic_flags), ptr(rhs_scaled), ptr(dst),
             ptr(psi if k == n_iters else None), *dims, ctypes.c_double(tau), st)
        poisson_sweeps.launches += 1
        src = dst
    return out, psi


poisson_sweeps.launches = 0
