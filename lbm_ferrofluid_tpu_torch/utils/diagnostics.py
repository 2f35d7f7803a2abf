"""Checks of a state between steps (``lbm_ferrofluid_tpu/utils/diagnostics.py``).

The NaN guard that ``SimulationRunner.run`` calls; the scalar
``diagnostics`` reduction is not ported yet.
"""

from __future__ import annotations

import torch

__all__ = ["assert_finite"]


def assert_finite(state, fields=("f", "rho", "vel")) -> None:
    """Raise FloatingPointError, naming the field and the step, if a
    field in ``fields`` holds a non-finite value (the exponential feq can
    pole at |u| -> c).  Absent fields are skipped, and a tuple field (a
    carried premac) is checked leaf by leaf."""
    for name in fields:
        value = getattr(state, name, None)
        for leaf in value if isinstance(value, tuple) else (value,):
            if torch.is_tensor(leaf) and not bool(torch.isfinite(leaf).all()):
                raise FloatingPointError(
                    f"non-finite values in state.{name} at step {int(state.step)}")
