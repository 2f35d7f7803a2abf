"""Tracing and step timing (``lbm_ferrofluid_tpu/utils/profiling.py``).

* ``trace(logdir)``: a context manager around ``torch.profiler`` (CPU and,
  where CUDA is available, the card's kernels) that writes a Chrome trace
  into ``logdir``;
* ``StepTimer``: wall-clock step timing with MLUPS, whose ``sync`` waits
  for the card (``torch.cuda.synchronize``) when the state lives there.

The JAX module's ``enable_compile_cache`` has no counterpart: eager
PyTorch compiles nothing, and the port's CUDA kernels are built once a
process (``ops/kernels/_lib.py``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import pathlib
import time

import torch

__all__ = ["trace", "StepTimer", "sync"]


def sync(state):
    """Block until the work that produced ``state`` has finished on the
    card; a state on the CPU is returned at once."""
    for fld in dataclasses.fields(state):
        value = getattr(state, fld.name)
        for leaf in value if isinstance(value, tuple) else (value,):
            if torch.is_tensor(leaf) and leaf.is_cuda:
                torch.cuda.synchronize(leaf.device)
                return state
    return state


@contextlib.contextmanager
def trace(logdir: str):
    """Profile everything inside the block; the Chrome trace goes to
    ``logdir/trace.json``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    path = pathlib.Path(logdir)
    path.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(path / "trace.json"))


class StepTimer:
    """Accumulates wall-clock over step calls; reports MLUPS.

    Usage:
        timer = StepTimer(sites=H*W)
        for _ in range(n):
            with timer:
                state = step(params, state)
            timer.sync(state)
        print(timer.summary())
    """

    def __init__(self, sites: int):
        self.sites = sites
        self.steps = 0
        self.seconds = 0.0
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds += time.perf_counter() - self._t0
        self.steps += 1
        return False

    def sync(self, state) -> None:
        """Wait for the card; the wait is added to the accumulated time."""
        t0 = time.perf_counter()
        sync(state)
        self.seconds += time.perf_counter() - t0

    @property
    def mlups(self) -> float:
        return self.sites * self.steps / max(self.seconds, 1e-12) / 1e6

    def summary(self) -> dict:
        return {
            "steps": self.steps,
            "seconds": round(self.seconds, 4),
            "mlups": round(self.mlups, 2),
        }
