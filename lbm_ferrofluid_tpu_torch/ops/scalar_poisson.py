"""Scalar collapse of the magnetic Poisson-LBM solve at tau == 1.

PyTorch twins of ``lbm_ferrofluid_tpu/ops/scalar_poisson.py`` (:113-241).
At tau == 1 the 19-channel Poisson distribution h is a rank-one function of
one scalar s, and full-way bounce-back is a lag-2 self-reflection, so the
solve collapses exactly to

    psi^{t+1}(x) = 1.5 * sum_{q>=1} w_q * s^t(x - e_q)   [s == 0 at obstacles]
                   + c(x) * s^{t-1}(x)
    s^{t+1}    = (psi^{t+1} + rhs_scaled) * fluid_mask

with the static wall-weight field c(x) = 1.5 * sum_{q: x-e_q obstacle} w_q.
The step carries the fused ``[B, 2, Z, Y, X]`` pair (s, s_prev) and the
``cmask`` field (-1 at obstacles, c(x) >= 0 at fluid cells).  The sweeps
themselves live in ``ops/kernels/scalar_poisson.py``.  D3Q19 only (the
D2Q9 collapse is ROADMAP A7).
"""

from __future__ import annotations

import numpy as np
import torch

from ..lattice import D3Q19
from ..utils.types import CellType

__all__ = [
    "INV_1MW0",
    "fluid_mask",
    "wall_weight_field",
    "make_cmask",
    "scalar_from_h",
    "s_prev_from_h",
    "compare_views",
]

_OBS = int(CellType.OBSTACLE)

#: 1/(1-w0) = 1/(2/3) = 1.5, exactly representable
INV_1MW0 = 1.5


def _roll(x, shift):
    return torch.roll(x, shift, dims=tuple(range(-len(shift), 0)))


def fluid_mask(magnetic_flags):
    """[B,1,Z,Y,X] float32, 1.0 at non-obstacle cells, 0.0 at obstacles."""
    return (magnetic_flags != _OBS).to(torch.float32)


def wall_weight_field(magnetic_flags):
    """c(x) = 1/(1-w0) sum_{q: x-e_q obs} w_q, masked to fluid cells."""
    lat = D3Q19
    shifts = lat.shifts()
    obs = (magnetic_flags == _OBS).to(torch.float32)
    c = None
    for q in range(1, lat.q):
        t = float(np.float32(lat.weights[q])) * _roll(obs, shifts[q])
        c = t if c is None else c + t
    return c * float(np.float32(INV_1MW0)) * fluid_mask(magnetic_flags)


def make_cmask(magnetic_flags):
    """-1.0 at obstacle cells, the wall weight c(x) >= 0 at fluid cells."""
    mask = fluid_mask(magnetic_flags)
    return wall_weight_field(magnetic_flags) * mask - (1.0 - mask)


def scalar_from_h(h, magnetic_flags):
    """s = psi(h) = 1.5 * sum_{q>=1} h_q of a canonical h (few-ulp exact),
    masked to exact zeros at obstacle cells."""
    hf = h.to(torch.float32)
    return (
        torch.sum(hf[:, 1:], dim=1, keepdim=True) * float(np.float32(INV_1MW0))
        * fluid_mask(magnetic_flags)
    )


def s_prev_from_h(h, magnetic_flags):
    """s_prev at wall-adjacent fluid cells from the wall channels: the
    obstacle cell x - e_q stores h_q = f32(w_q * s_prev(x)).  Cells with no
    obstacle neighbour return 0 (c(x) == 0 there, the value is never read)."""
    lat = D3Q19
    shifts = lat.shifts()
    hf = h.to(torch.float32)
    obs = (magnetic_flags == _OBS).to(torch.float32)
    num = torch.zeros_like(hf[:, :1])
    den = torch.zeros_like(hf[:, :1])
    for q in range(1, lat.q):
        src_obs = _roll(obs, shifts[q])
        num = num + src_obs * _roll(hf[:, q:q + 1], shifts[q])
        den = den + src_obs * float(np.float32(lat.weights[q]))
    s_prev = torch.where(
        den > 0, num / torch.clamp(den, min=1e-30), torch.zeros_like(num)
    )
    return s_prev * fluid_mask(magnetic_flags)


def compare_views(h_scalar, h_channel, magnetic_flags):
    """Comparable views of a scalar-carry h and a channel-form h.

    Returns ``(a, b)``: the carry's (s, s_prev) with s_prev masked to
    wall-adjacent cells, and the same pair recovered from the channel h
    through the collapse contract.  s_prev is recoverable from channel h
    only at wall-adjacent fluid cells, and the solve reads it nowhere else,
    so both sides mask it."""
    wmask = wall_weight_field(magnetic_flags) > 0
    b = torch.cat([
        scalar_from_h(h_channel, magnetic_flags),
        torch.where(wmask, s_prev_from_h(h_channel, magnetic_flags), 0.0),
    ], dim=1)
    a = torch.cat([h_scalar[:, :1], torch.where(wmask, h_scalar[:, 1:2], 0.0)], dim=1)
    return a, b
