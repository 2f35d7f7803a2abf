"""Simulation states, and their exchange with the JAX package.

``SinglePhaseState``, ``HCZState`` (with ``g`` and ``pressure`` None for
the Shan-Chen model) and ``FerrofluidState`` have the fields of the JAX
package's (``lbm_ferrofluid_tpu/models/state.py``), held as tensors on one
device, in 2D ([B, C, Y, X]) or 3D ([B, C, Z, Y, X]).
A ferrofluid state comes in three forms, which ``models/ferrofluid.py:
ferrofluid_step`` steps as they are:

* un-carried (``init_ferrofluid_state``): ``premac`` None, ``phi``,
  ``force`` and ``H_ext`` tensors;
* the capillogue steady state (``prime_premac``): ``premac`` the 6-tuple
  (rho, vel, density, m0g, m1g, rhs_scaled) of this step's streamed macros
  and pre-scaled Poisson source, emitted by the previous step; ``phi``,
  ``force`` and ``H_ext`` None (``phi_field`` and ``make_H_ext`` rebuild
  them on demand);
* the epilogue steady state (a JAX state primed where its capillogue does
  not fit): ``premac`` the 5-tuple (rho, vel, density, m0g, m1g); ``phi``
  and ``force`` tensors.

In each, ``h`` is the [1, 19, Z, Y, X] channel distribution with ``cmask``
None, or, once primed where the tau == 1 collapse applies, the fused
[1, 2, Z, Y, X] (s, s_prev) pair of the scalar Poisson carry with
``cmask`` its static obstacle/wall-weight field.

``step`` is a Python int.  :func:`to_numpy` and :func:`from_numpy` move a
state to and from a dict of numpy arrays keyed by these field names, so a
JAX state given as numpy arrays becomes a port state that computes the
same thing; a dict with an ``h`` field is a ferrofluid state, one with a
``density`` field and no ``h`` an HCZ (or Shan-Chen) state, and one with
neither a single-phase state.

bfloat16 leaves cross as their bits.  The JAX package hands them over as
numpy arrays of the ``ml_dtypes`` bfloat16 dtype, which ``torch.as_tensor``
does not take, and ``Tensor.numpy()`` does not take a bfloat16 tensor, so
both directions go through a 16-bit integer view.  The port does not
import ``ml_dtypes``: :func:`to_numpy` returns bfloat16 arrays when some
module of the process has registered that dtype with numpy (JAX does), and
otherwise uint16 arrays of the bits whose dtype carries
``metadata={"bfloat16": True}``; :func:`from_numpy` takes either.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils.device import resolve_device

__all__ = [
    "SinglePhaseState", "HCZState", "FerrofluidState", "from_numpy", "to_numpy", "BF16_BITS",
    "field_shapes",
]


@dataclasses.dataclass
class SinglePhaseState:
    """Single-phase BGK/KBC: one distribution f and a constant body force."""

    f: torch.Tensor
    rho: torch.Tensor
    vel: torch.Tensor
    force: torch.Tensor
    flags: torch.Tensor
    step: int

    def replace(self, **kw) -> "SinglePhaseState":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class HCZState:
    """HCZ two-distribution multiphase (f, g), with optional velocity
    pinning: vel <- where(vel_pin_mask, vel_pin_value, vel) after the
    streamed macros and after the capillary stage.  The Shan-Chen model
    uses it with ``g`` and ``pressure`` None."""

    f: torch.Tensor
    g: torch.Tensor | None
    rho: torch.Tensor
    vel: torch.Tensor
    density: torch.Tensor
    pressure: torch.Tensor | None
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


def field_shapes(params, res: tuple[int, ...], batch: int = 1) -> dict:
    """Canonical field shapes for a resolution (z, y, x ordering)."""
    lat = params.lattice
    return {
        "f": (batch, lat.q, *res),
        "scalar": (batch, 1, *res),
        "vector": (batch, lat.dim, *res),
    }


#: uint16 bits of bfloat16 values, where numpy has no bfloat16 dtype
BF16_BITS = np.dtype(np.uint16, metadata={"bfloat16": True})


def _is_bf16(dtype: np.dtype) -> bool:
    return dtype.name == "bfloat16" or bool((dtype.metadata or {}).get("bfloat16"))


def _to_tensor(value, device):
    if value is None:
        return None
    if isinstance(value, (tuple, list)):
        return tuple(_to_tensor(v, device) for v in value)
    a = np.array(value)
    if _is_bf16(a.dtype):
        bits = torch.from_numpy(np.ascontiguousarray(a).view(np.int16))
        return bits.view(torch.bfloat16).to(device)
    return torch.as_tensor(a, device=device)


def from_numpy(fields: dict, device=None):
    """A state from numpy arrays keyed by the field names of
    ``FerrofluidState`` (when ``fields`` has ``h``), ``HCZState`` (``density``
    without ``h``) or ``SinglePhaseState`` (neither); None leaves and the
    premac/H_ext_mac tuples as they are."""
    dev = resolve_device(device)
    cls = (FerrofluidState if "h" in fields
           else HCZState if "density" in fields else SinglePhaseState)
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
    value = value.detach().cpu()
    if value.dtype != torch.bfloat16:
        return value.numpy()
    bits = value.contiguous().view(torch.int16).numpy().view(np.uint16)
    try:
        return bits.view(np.dtype("bfloat16"))
    except TypeError:  # no module of this process registered the dtype
        return bits.view(BF16_BITS)


def to_numpy(state) -> dict:
    """The state as numpy arrays keyed by field name; ``step`` becomes an
    int32 scalar array as in the JAX state."""
    out = {}
    for fld in dataclasses.fields(state):
        value = getattr(state, fld.name)
        out[fld.name] = (np.asarray(value, np.int32) if fld.name == "step"
                         else _to_array(value))
    return out
