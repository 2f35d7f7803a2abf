"""Simulation runner: a Python step loop, finite-field checks and MLUPS timing.

Port of ``lbm_ferrofluid_tpu/models/runner.py``.  PyTorch runs eagerly, so
the runner loops over steps in Python (the JAX package scans chunks of
steps into one XLA computation).  MLUPS counts outer steps x cells, as the
JAX runner does (:106-144): one ferrofluid step, with its Poisson sweeps,
or one single-phase, Shan-Chen or HCZ step is one lattice update.  On the
card a timed region ends in ``torch.cuda.synchronize()``.
"""

from __future__ import annotations

import inspect
import time

import numpy as np
import torch

from ..utils.device import resolve_device
from ..utils.diagnostics import assert_finite
from ..utils.profiling import sync
from .ferrofluid import prime_premac
from .params import SimulationParams

__all__ = ["SimulationRunner", "assert_finite", "sync"]


def _takes_device(step_fn) -> bool:
    """Whether ``step_fn`` accepts a ``device`` keyword."""
    try:
        params = inspect.signature(step_fn).parameters.values()
    except (TypeError, ValueError):
        return False
    return any(p.name == "device" or p.kind is p.VAR_KEYWORD for p in params)


class SimulationRunner:
    """Drives ``step_fn(params, state) -> state`` (``singlephase_step``,
    ``sc_step``, ``hcz_step``, ``ferrofluid_step`` or any compatible
    function) over many steps, as the JAX runner does (runner.py:39-47);
    a step function that takes a ``device`` keyword is given the runner's.
    With ``mesh`` (``parallel/mesh.py``) the state is this rank's part (a
    slab, a 2D or 3D block, batch elements, or a block of several batch
    elements): the step function and
    priming are given the mesh, and the runner runs and synchronises on the
    mesh's device (each rank times its own).  ``io_fn`` and the finite
    checks see the rank's part; an ``io_fn`` that wants the whole state
    calls ``parallel.gather_state(state, mesh)``, a collective that every
    rank's ``io_fn`` makes at the same steps.

    Runs on the card unless ``device="cpu"``."""

    def __init__(self, params: SimulationParams, step_fn, *, device=None, mesh=None):
        self.params = params
        self._step = step_fn
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else resolve_device(device)
        self._step_kw = {"device": self.device} if _takes_device(step_fn) else {}
        if mesh is not None:
            self._step_kw["mesh"] = mesh

    def step(self, state):
        return self._step(self.params, state, **self._step_kw)

    def prepare(self, state):
        """Prime a ferrofluid state's carried steady state before the loop;
        states without ``premac`` are returned as they are (the JAX
        runner's ``_prepare``, :56-64)."""
        if getattr(state, "premac", "absent") is None:
            return prime_premac(self.params, state, device=self.device, mesh=self.mesh)
        return state

    def run(self, state, n_steps: int, *, io_interval: int = 0, io_fn=None,
            nan_guard: bool = False, check_every: int = 0):
        """Advance ``n_steps``.  With ``io_interval`` > 0, call ``io_fn(state)``
        every ``io_interval`` steps and after the last step, and with
        ``nan_guard`` check at those points that f, rho and vel are finite
        (``utils/diagnostics.py:assert_finite``, whose message names the
        step), as the JAX runner does (runner.py:83-103).  ``check_every`` > 0
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
