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
``cmask`` field (-1 at obstacles, c(x) >= 0 at fluid cells).  The same
algebra holds on D2Q9 (reference LBM_magnetic_2d.py:88-164), whose
1/(1 - w0) = 1.8 is not a float32 value, so psi there divides by
f32(1 - w0) as the channel-form solve does.  The lattice follows from the
field's rank.  The 3D sweeps live in ``ops/kernels/scalar_poisson.py`` (B1
and its plain version, in the TPU kernel's grouped tap order); the 2D
solve runs :func:`scalar_sweeps_exact`, the JAX package's
``scalar_sweeps_jnp(order="exact")``, since no kernel takes D2Q9 there.
"""

from __future__ import annotations

import numpy as np
import torch

from ..lattice import get_lattice
from ..utils.types import CellType, chan_sum

__all__ = [
    "INV_1MW0",
    "fluid_mask",
    "wall_weight_field",
    "make_cmask",
    "scalar_from_h",
    "s_prev_from_h",
    "scalar_sweeps_exact",
    "h_from_scalar",
    "compare_views",
]

_OBS = int(CellType.OBSTACLE)

#: 1/(1-w0) = 1/(2/3) = 1.5, exactly representable
INV_1MW0 = 1.5


def _lat_of(field):
    """D3Q19 for [B, C, Z, Y, X] fields, D2Q9 for [B, C, Y, X]."""
    return get_lattice(field.ndim - 2)


def _psi_of(acc, lat):
    """psi = acc / (1 - w0): times the exact 1.5 on D3Q19, divided by
    f32(1 - w0) on D2Q9 (JAX ``_psi_of``)."""
    if lat.dim == 3:
        return acc * float(np.float32(INV_1MW0))
    return acc / float(np.float32(1.0 - float(lat.weights[0])))


def _roll(x, shift):
    return torch.roll(x, shift, dims=tuple(range(-len(shift), 0)))


def fluid_mask(magnetic_flags):
    """[B,1,Z,Y,X] float32, 1.0 at non-obstacle cells, 0.0 at obstacles."""
    return (magnetic_flags != _OBS).to(torch.float32)


def wall_weight_field(magnetic_flags):
    """c(x) = 1/(1-w0) sum_{q: x-e_q obs} w_q, masked to fluid cells."""
    lat = _lat_of(magnetic_flags)
    shifts = lat.shifts()
    obs = (magnetic_flags == _OBS).to(torch.float32)
    c = None
    for q in range(1, lat.q):
        t = float(np.float32(lat.weights[q])) * _roll(obs, shifts[q])
        c = t if c is None else c + t
    return _psi_of(c, lat) * fluid_mask(magnetic_flags)


def make_cmask(magnetic_flags):
    """-1.0 at obstacle cells, the wall weight c(x) >= 0 at fluid cells."""
    mask = fluid_mask(magnetic_flags)
    return wall_weight_field(magnetic_flags) * mask - (1.0 - mask)


def scalar_from_h(h, magnetic_flags):
    """s = psi(h) = sum_{q>=1} h_q / (1 - w0) of a canonical h (few-ulp
    exact), masked to exact zeros at obstacle cells."""
    hf = h.to(torch.float32)
    return (
        _psi_of(chan_sum(hf[:, 1:], keepdim=True), _lat_of(h))
        * fluid_mask(magnetic_flags)
    )


def s_prev_from_h(h, magnetic_flags):
    """s_prev at wall-adjacent fluid cells from the wall channels: the
    obstacle cell x - e_q stores h_q = f32(w_q * s_prev(x)).  Cells with no
    obstacle neighbour return 0 (c(x) == 0 there, the value is never read)."""
    lat = _lat_of(h)
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


def scalar_sweeps_exact(s, s_prev, rhs_scaled, magnetic_flags, n_iters):
    """``n_iters`` scalar sweeps in the channel form's order; returns
    (psi_last, s_last, s_prev_last).  JAX ``scalar_sweeps_jnp`` with
    ``order="exact"`` (:242-314): per-tap products f32(w_q * tap), the wall
    source substituted per tap, summed in ascending q, then psi as
    :func:`_psi_of` forms it.  ``s`` and ``s_prev`` are fluid-masked."""
    lat = _lat_of(s)
    shifts = lat.shifts()
    mask = fluid_mask(magnetic_flags)
    obs_f = 1.0 - mask
    wall_m = [None] + [_roll(obs_f, shifts[q]) for q in range(1, lat.q)]
    w = [float(np.float32(v)) for v in lat.weights]
    psi = torch.zeros_like(s)
    for _ in range(n_iters):
        acc = None
        for q in range(1, lat.q):
            t = w[q] * (_roll(s, shifts[q]) + wall_m[q] * s_prev)
            acc = t if acc is None else acc + t
        psi = _psi_of(acc, lat)
        s, s_prev = (psi + rhs_scaled) * mask, s
    return psi, s, s_prev


def h_from_scalar(s, s_prev, rhs_scaled, magnetic_flags, h_dtype):
    """The 19-channel h a channel-form solve would carry (for checkpoints
    and other consumers of the channel form):

    * fluid q >= 1: w_q * s;
    * fluid q == 0: (w0 - 1) * psi + w0 * rhs with psi = s - rhs (inert for
      the solve);
    * obstacle channels read by fluid (x + e_q fluid): w_q * s_prev(x + e_q),
      the lag-2 reflection value the channel dynamics would hold;
    * deeper obstacle channels: 0, which no fluid cell ever reads.

    ``h_dtype`` is a torch dtype or its name."""
    lat = _lat_of(magnetic_flags)
    shifts = lat.shifts()
    mask = fluid_mask(magnetic_flags)
    obs = 1.0 - mask
    sf = s.to(torch.float32)
    psi = sf - rhs_scaled
    w0 = float(lat.weights[0])
    chans = [((w0 - 1.0) * psi + w0 * rhs_scaled) * mask]
    spf = s_prev.to(torch.float32) * mask
    for q in range(1, lat.q):
        wq = float(np.float32(lat.weights[q]))
        # the obstacle cell x holds w_q * s_prev(x + e_q): s_prev pulled
        # back along -e_q
        lag = wq * _roll(spf, tuple(-v for v in shifts[q]))
        chans.append(wq * sf * mask + lag * obs)
    dtype = getattr(torch, h_dtype) if isinstance(h_dtype, str) else h_dtype
    return torch.cat(chans, dim=1).to(dtype)


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
