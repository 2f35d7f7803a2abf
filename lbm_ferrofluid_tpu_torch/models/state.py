"""Simulation states, and their exchange with the JAX package.

``HCZState`` and ``FerrofluidState`` have the fields of the JAX package's
(``lbm_ferrofluid_tpu/models/state.py``), held as tensors on one device.
On the carried ferrofluid steady state (``models/ferrofluid.py:prime_premac``):

* ``premac`` is the 6-tuple (rho, vel, density, m0g, m1g, rhs_scaled) of
  this step's streamed macros and pre-scaled Poisson source, emitted by the
  previous step;
* ``h`` is the fused [1, 2, Z, Y, X] (s, s_prev) pair of the tau == 1
  scalar Poisson carry and ``cmask`` its static obstacle/wall-weight field;
* ``phi``, ``force`` and ``H_ext`` are None (``phi_field`` and
  ``make_H_ext`` rebuild them on demand).

``step`` is a Python int.  :func:`to_numpy` and :func:`from_numpy` move a
state to and from a dict of numpy arrays keyed by these field names, so a
JAX state given as numpy arrays becomes a port state that computes the
same thing; a dict with an ``h`` field is a ferrofluid state, one without
it an HCZ state.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils.device import resolve_device

__all__ = ["HCZState", "FerrofluidState", "from_numpy", "to_numpy"]


@dataclasses.dataclass
class HCZState:
    """HCZ two-distribution multiphase (f, g), with optional velocity
    pinning: vel <- where(vel_pin_mask, vel_pin_value, vel) after the
    streamed macros and after the capillary stage."""

    f: torch.Tensor
    g: torch.Tensor
    rho: torch.Tensor
    vel: torch.Tensor
    density: torch.Tensor
    pressure: torch.Tensor
    force: torch.Tensor
    flags: torch.Tensor
    step: int
    vel_pin_mask: torch.Tensor | None = None
    vel_pin_value: torch.Tensor | None = None

    def replace(self, **kw) -> "HCZState":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class FerrofluidState:
    """HCZ multiphase (f, g) + magnetic Poisson carry (h)."""

    f: torch.Tensor
    g: torch.Tensor
    h: torch.Tensor
    rho: torch.Tensor
    vel: torch.Tensor
    density: torch.Tensor
    pressure: torch.Tensor
    force: torch.Tensor | None
    phi: torch.Tensor | None
    flags: torch.Tensor
    magnetic_flags: torch.Tensor
    H_ext: torch.Tensor | None
    H_ext_mac: tuple
    step: int
    premac: tuple | None = None
    cmask: torch.Tensor | None = None

    def replace(self, **kw) -> "FerrofluidState":
        return dataclasses.replace(self, **kw)


def _to_tensor(value, device):
    if value is None:
        return None
    if isinstance(value, (tuple, list)):
        return tuple(_to_tensor(v, device) for v in value)
    return torch.as_tensor(np.array(value), device=device)


def from_numpy(fields: dict, device=None):
    """A state from numpy arrays keyed by the field names of
    ``FerrofluidState`` (when ``fields`` has ``h``) or ``HCZState`` (None
    leaves and the premac/H_ext_mac tuples as they are)."""
    dev = resolve_device(device)
    cls = FerrofluidState if "h" in fields else HCZState
    kw = {}
    for fld in dataclasses.fields(cls):
        if fld.name not in fields:
            if fld.default is dataclasses.MISSING:
                raise KeyError(f"from_numpy: missing field {fld.name!r}")
            continue
        value = fields[fld.name]
        kw[fld.name] = (int(np.asarray(value)) if fld.name == "step"
                        else _to_tensor(value, dev))
    return cls(**kw)


def _to_array(value):
    if value is None:
        return None
    if isinstance(value, tuple):
        return tuple(_to_array(v) for v in value)
    return value.detach().cpu().numpy()


def to_numpy(state) -> dict:
    """The state as numpy arrays keyed by field name; ``step`` becomes an
    int32 scalar array as in the JAX state."""
    out = {}
    for fld in dataclasses.fields(state):
        value = getattr(state, fld.name)
        out[fld.name] = (np.asarray(value, np.int32) if fld.name == "step"
                         else _to_array(value))
    return out
