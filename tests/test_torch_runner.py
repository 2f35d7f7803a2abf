"""The port's SimulationRunner against the JAX runner's interface.

``run(state, n_steps, *, io_interval, io_fn, nan_guard)`` and
``benchmark(state, *, n_steps, warmup, repeats)`` take the JAX runner's
arguments (``lbm_ferrofluid_tpu/models/runner.py:83-144``) and give its
results: the IO hook sees the same steps as the JAX runner's (the twin of
``tests/test_runner.py:38-43``), the benchmark returns the JAX runner's
keys.  The port's state is the 3D HCZ ``multiphase_3d`` at 8^3 on the CPU
(the JAX side runs its own singlephase 2D state, which the port has not
ported, for the sequence and the keys).  The NaN guard and the step
function's contract (``nan_guard`` checks f, rho and vel and names the
step; any ``step_fn(params, state)`` runs) are held to the JAX runner on
the same 3D HCZ scene, stepped by a two-argument function that only counts
steps, so that a NaN stays in the field it was put in.
"""

import dataclasses
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
from lbm_ferrofluid_tpu.models.scenes import multiphase_3d as jmultiphase_3d  # noqa: E402

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


def _count_step(params, state):
    """A two-argument step function that only advances the step count, in
    either package's state."""
    return dataclasses.replace(state, step=state.step + 1)


def _both_with_nan_in(name):
    """(port runner, port state, JAX runner, JAX state) on ``multiphase_3d``
    at 8^3, each state with one NaN in the field ``name`` (none for None)."""
    params, state = multiphase_3d(res=RES, device="cpu")
    jparams, jstate = jmultiphase_3d(res=RES)
    if name is not None:
        t = getattr(state, name).clone()
        t[0, 0, 4, 4, 4] = float("nan")
        state = state.replace(**{name: t})
        jstate = dataclasses.replace(
            jstate, **{name: getattr(jstate, name).at[0, 0, 4, 4, 4].set(float("nan"))})
    return (SimulationRunner(params, _count_step, device="cpu"), state,
            JRunner(jparams, _count_step), jstate)


def test_nan_only_in_g_passes_both_guards():
    runner, state, jrunner, jstate = _both_with_nan_in("g")
    out = runner.run(state, 4, io_interval=2, nan_guard=True)
    jout = jrunner.run(jstate, 4, io_interval=2, nan_guard=True)
    assert out.step == int(jout.step) == 4
    assert not bool(torch.isfinite(out.g).all()) and not bool(np.isfinite(jout.g).all())


def test_nan_in_f_raises_in_both_naming_the_step():
    runner, state, jrunner, jstate = _both_with_nan_in("f")
    messages = []
    for run, st in ((runner.run, state), (jrunner.run, jstate)):
        with pytest.raises(FloatingPointError) as err:
            run(st, 4, io_interval=2, nan_guard=True)
        messages.append(str(err.value))
    assert messages[0] == messages[1] == "non-finite values in state.f at step 2"


def test_two_argument_step_fn_runs_in_both():
    runner, state, jrunner, jstate = _both_with_nan_in(None)
    seen, jseen = [], []
    out = runner.run(state, 3, io_interval=1, io_fn=lambda s: seen.append(s.step),
                     nan_guard=True)
    jout = jrunner.run(jstate, 3, io_interval=1, io_fn=lambda s: jseen.append(int(s.step)),
                       nan_guard=True)
    assert out.step == int(jout.step) == 3 and seen == jseen == [1, 2, 3]
    assert torch.equal(out.f, state.f)
