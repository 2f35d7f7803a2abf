"""Per-step scalar diagnostics and the NaN guard
(``lbm_ferrofluid_tpu/utils/diagnostics.py``).

``assert_finite`` is the guard that ``SimulationRunner.run`` calls;
``diagnostics`` gives a few global scalars of rho and vel as 0-d tensors
on their device (read them with ``float``).
"""

from __future__ import annotations

import torch

__all__ = ["diagnostics", "assert_finite"]


def diagnostics(rho, vel) -> dict:
    """Cheap global scalars: {mass, kinetic_energy, max_speed, finite}."""
    u2 = torch.sum(vel * vel, dim=1, keepdim=True)
    return {
        "mass": torch.sum(rho),
        "kinetic_energy": 0.5 * torch.sum(rho * u2),
        "max_speed": torch.sqrt(torch.max(u2)),
        "finite": torch.isfinite(rho).all() & torch.isfinite(vel).all(),
    }


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
