"""The port's SimulationRunner against the JAX runner's interface.

``run(state, n_steps, *, io_interval, io_fn, nan_guard)`` and
``benchmark(state, *, n_steps, warmup, repeats)`` take the JAX runner's
arguments (``lbm_ferrofluid_tpu/models/runner.py:83-144``) and give its
results: the IO hook sees the same steps as the JAX runner's (the twin of
``tests/test_runner.py:38-43``), the benchmark returns the JAX runner's
keys.  The port's state is the 3D HCZ ``multiphase_3d`` at 8^3 on the CPU
(the JAX side runs its own singlephase 2D state, which the port has not
ported, for the sequence and the keys).
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lbm_ferrofluid_tpu import CellType  # noqa: E402
from lbm_ferrofluid_tpu.models import SimulationParams as JParams  # noqa: E402
from lbm_ferrofluid_tpu.models import SimulationRunner as JRunner  # noqa: E402
from lbm_ferrofluid_tpu.models import (  # noqa: E402
    init_singlephase_state,
    singlephase_step_impl,
)

from lbm_ferrofluid_tpu_torch.models import (  # noqa: E402
    SimulationRunner,
    hcz_step,
    multiphase_3d,
)

RES = (8, 8, 8)


def _runner():
    params, state = multiphase_3d(res=RES, device="cpu")
    return SimulationRunner(params, hcz_step, device="cpu"), state


def _jax_runner():
    params = JParams(dim=2, tau=0.8)
    flags = np.full((1, 1, 16, 16), int(CellType.FLUID), np.uint8)
    rho = np.full((1, 1, 16, 16), 0.265, np.float32)
    vel = np.random.default_rng(7).uniform(-0.05, 0.05, (1, 2, 16, 16)).astype(np.float32)
    return JRunner(params, singlephase_step_impl), init_singlephase_state(params, rho, vel,
                                                                         flags)


def test_io_hook_sees_the_jax_runners_steps():
    jrunner, jstate = _jax_runner()
    jseen = []
    jrunner.run(jstate, 10, io_interval=3, io_fn=lambda s: jseen.append(int(s.step)))
    runner, state = _runner()
    seen = []
    out = runner.run(state, 10, io_interval=3, io_fn=lambda s: seen.append(s.step))
    assert seen == jseen == [3, 6, 9, 10]
    assert out.step == 10


def test_io_hook_off_without_an_interval():
    runner, state = _runner()
    seen = []
    assert runner.run(state, 4, io_fn=lambda s: seen.append(s.step)).step == 4
    assert seen == []


def test_nan_guard_raises_on_a_nan_in_f():
    runner, state = _runner()
    f = state.f.clone()
    f[0, 0, 4, 4, 4] = float("nan")
    bad = state.replace(f=f)
    with pytest.raises(FloatingPointError, match="non-finite"):
        runner.run(bad, 4, io_interval=2, nan_guard=True)
    # without the guard the run goes on and hands the NaN back
    out = runner.run(bad, 2)
    assert not bool(torch.isfinite(out.f).all())


def test_benchmark_repeats_give_the_jax_runners_keys():
    jrunner, jstate = _jax_runner()
    _, jstats = jrunner.benchmark(jstate, n_steps=2, warmup=1, repeats=3)
    runner, state = _runner()
    out, stats = runner.benchmark(state, n_steps=2, warmup=1, repeats=3)
    assert set(jstats) <= set(stats)
    assert out.step == 1 + 3 * 2
    assert stats["steps"] == 2 and stats["sites"] == math.prod(RES)
    assert len(stats["seconds_all"]) == 3
    assert stats["seconds"] == float(np.median(stats["seconds_all"]))
    assert stats["mlups"] == pytest.approx(math.prod(RES) * 2 / stats["seconds"] / 1e6)
    assert stats["mlups_best"] == pytest.approx(
        math.prod(RES) * 2 / min(stats["seconds_all"]) / 1e6)
    assert stats["mlups_best"] >= stats["mlups"] > 0


def test_benchmark_without_warmup_times_every_step():
    runner, state = _runner()
    out, stats = runner.benchmark(state, n_steps=3, warmup=0)
    assert out.step == 3 and len(stats["seconds_all"]) == 1


def test_check_every_still_checks():
    runner, state = _runner()
    assert runner.run(state, 2, check_every=1).step == 2
    f = state.f.clone()
    f[0, 3, 2, 2, 2] = float("inf")
    with pytest.raises(FloatingPointError):
        runner.run(state.replace(f=f), 2, check_every=1)
