"""Streaming (propagation) and bounce-back, in plain PyTorch.

Twins of ``lbm_ferrofluid_tpu/ops/stream.py``.  Interior streaming is a
periodic shift of each population along its lattice link
(LBM_propagation_3d.py:18-111), i.e. a ``torch.roll`` per direction;
bounce-back (LBM_propagation_2d.py:70-86) is the opposite-channel
permutation masked onto OBSTACLE cells.  ``stream_bounce_macro`` plus
``stream_bounce_moments`` is the plain version of the prologue kernel
(``ops/kernels/fused_step.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..lattice import Lattice
from ..utils.types import CellType

__all__ = ["stream", "bounce_back", "stream_bounce_moments", "stream_bounce_macro"]


def stream(lat: Lattice, f):
    """Periodic pull streaming: population q moves one cell along e_q."""
    dims = tuple(range(-lat.dim, 0))
    parts = []
    for q, shift in enumerate(lat.shifts()):
        fq = f[:, q]
        parts.append(torch.roll(fq, shift, dims=dims) if any(shift) else fq)
    return torch.stack(parts, dim=1)


def bounce_back(lat: Lattice, f, flags):
    """Full-way bounce back: on OBSTACLE cells f_q <- f_opp(q)."""
    f_inv = f[:, torch.as_tensor(lat.opposite, device=f.device)]
    return torch.where(flags == int(CellType.OBSTACLE), f_inv, f)


def stream_bounce_moments(lat: Lattice, f, flags):
    """stream -> bounce-back -> raw moments: (f_post, Σ_q f_q, Σ_q f_q e_q)."""
    f = bounce_back(lat, stream(lat, f), flags)
    m0 = torch.sum(f, dim=1, keepdim=True)
    moments = []
    for d in range(lat.dim):
        ed = torch.as_tensor(
            lat.e[:, d].reshape(1, lat.q, *([1] * lat.dim)).astype(np.float64),
            dtype=f.dtype, device=f.device,
        )
        moments.append(torch.sum(f * ed, dim=1, keepdim=True))
    return f, m0, torch.cat(moments, dim=1)


def stream_bounce_macro(lat: Lattice, f, flags, rho_old, vel_old, *, c,
                        rho_gas, rho_fluid, density_gas, density_fluid):
    """stream -> bounce-back -> macro fields frozen on OBSTACLE cells ->
    linear density map.  Returns (f_post, rho, vel, density)."""
    f2, m0, m1 = stream_bounce_moments(lat, f, flags)
    is_obs = flags == int(CellType.OBSTACLE)
    rho = torch.where(is_obs, rho_old, m0)
    vel = torch.where(is_obs, vel_old, m1 * (c / rho))
    density = density_gas + (density_fluid - density_gas) * (
        (rho - rho_gas) / (rho_fluid - rho_gas)
    )
    return f2, rho, vel, density
