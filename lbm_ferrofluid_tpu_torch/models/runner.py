"""Simulation runner: a Python step loop, finite-field checks and MLUPS timing.

Port of ``lbm_ferrofluid_tpu/models/runner.py``.  PyTorch runs eagerly, so
the runner loops over steps in Python (the JAX package scans chunks of
steps into one XLA computation).  MLUPS counts outer steps x cells, as the
JAX runner does (:106-144): one ferrofluid step, with its Poisson sweeps,
or one HCZ step is one lattice update.  On the card a timed region ends in
``torch.cuda.synchronize()``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..utils.device import resolve_device
from .ferrofluid import prime_premac
from .params import SimulationParams

__all__ = ["SimulationRunner", "assert_finite"]


def assert_finite(state) -> None:
    """Raise FloatingPointError if a floating field of ``state`` is not
    finite."""
    for name, value in vars(state).items():
        leaves = value if isinstance(value, tuple) else (value,)
        for leaf in leaves:
            if torch.is_tensor(leaf) and leaf.is_floating_point():
                if not bool(torch.isfinite(leaf).all()):
                    raise FloatingPointError(f"non-finite values in state.{name}")


class SimulationRunner:
    """Drives ``step_fn(params, state, device=...) -> state`` (``hcz_step``
    or ``ferrofluid_step``) over many steps, as the JAX runner takes
    ``step_fn`` (runner.py:47).

    Runs on the card unless ``device="cpu"``."""

    def __init__(self, params: SimulationParams, step_fn, *, device=None):
        self.params = params
        self._step = step_fn
        self.device = resolve_device(device)

    def step(self, state):
        return self._step(self.params, state, device=self.device)

    def prepare(self, state):
        """Prime a ferrofluid state's carried steady state before the loop;
        states without ``premac`` are returned as they are (the JAX
        runner's ``_prepare``, :56-64)."""
        if getattr(state, "premac", "absent") is None:
            return prime_premac(self.params, state, device=self.device)
        return state

    def run(self, state, n_steps: int, *, io_interval: int = 0, io_fn=None,
            nan_guard: bool = False, check_every: int = 0):
        """Advance ``n_steps``.  With ``io_interval`` > 0, call ``io_fn(state)``
        every ``io_interval`` steps and after the last step, and with
        ``nan_guard`` check at those points that the fields are finite
        (:func:`assert_finite`; the exponential feq can pole at |u| -> c),
        as the JAX runner does (runner.py:83-103).  ``check_every`` > 0
        checks every that many steps, whatever ``io_interval`` is."""
        state = self.prepare(state)
        io = io_interval > 0 and (io_fn is not None or nan_guard)
        for done in range(1, n_steps + 1):
            state = self.step(state)
            if check_every and done % check_every == 0:
                assert_finite(state)
            if io and (done % io_interval == 0 or done == n_steps):
                if nan_guard:
                    assert_finite(state)
                if io_fn is not None:
                    io_fn(state)
        return state

    def benchmark(self, state, *, n_steps: int = 50, warmup: int = 5, repeats: int = 1):
        """Wall-clock MLUPS (million lattice-site updates per second) over
        ``n_steps`` steps, after ``warmup`` untimed steps (none at
        ``warmup=0``: the JAX runner always runs one untimed chunk, since
        it must compile it; eager steps need no compile).  The timed steps
        run ``repeats`` times, each ending in ``torch.cuda.synchronize()``
        on the card; ``mlups`` and ``seconds`` are the medians, with
        ``mlups_best`` and every repeat's ``seconds_all`` (the JAX
        runner's keys, :106-144)."""
        state = self.prepare(state)
        for _ in range(warmup):
            state = self.step(state)
        self._sync()
        times = []
        for _ in range(max(1, repeats)):
            t0 = time.perf_counter()
            for _ in range(n_steps):
                state = self.step(state)
            self._sync()
            times.append(time.perf_counter() - t0)
        seconds = float(np.median(times))
        res = tuple(state.rho.shape[2:])
        sites = state.rho.shape[0] * int(np.prod(res))
        return state, {
            "mlups": sites * n_steps / seconds / 1e6,
            "mlups_best": sites * n_steps / min(times) / 1e6,
            "seconds": seconds,
            "seconds_all": times,
            "steps": n_steps,
            "sites": sites,
            "res": res,
            "device": str(self.device),
        }

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
