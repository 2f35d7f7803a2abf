"""The port's small utilities against the JAX package's: ``diagnostics``
(keys and values at 1e-6), ``profiling.trace``/``StepTimer``,
``celltype_colormap``, ``field_shapes``, the runner's ``sync``,
``vorticity_2d`` (1e-6 in float32, 1e-12 in float64) and ``h_from_scalar``
(held through ``compare_views`` and channel by channel)."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_ferrofluid_tpu import models as jm
from lbm_ferrofluid_tpu.ops import moments as jmom
from lbm_ferrofluid_tpu.ops import scalar_poisson as jsp
from lbm_ferrofluid_tpu.utils import diagnostics as jdiag
from lbm_ferrofluid_tpu.utils import types as jtypes
from lbm_ferrofluid_tpu_torch import models as tm
from lbm_ferrofluid_tpu_torch.models import runner as trunner
from lbm_ferrofluid_tpu_torch.models import state as tstate
from lbm_ferrofluid_tpu_torch.ops import moments as tmom
from lbm_ferrofluid_tpu_torch.ops import scalar_poisson as tsp
from lbm_ferrofluid_tpu_torch.utils import diagnostics as tdiag
from lbm_ferrofluid_tpu_torch.utils import profiling
from lbm_ferrofluid_tpu_torch.utils import types as ttypes


@pytest.fixture(autouse=True)
def _one_thread():
    """One PyTorch thread: the tier-1 run puts six test processes on the
    machine's cores, and PyTorch's default pool would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("dim", [2, 3])


def test_diagnostics_equal_jax(dim):
    rng = np.random.default_rng(dim)
    res = (12, 10) if dim == 2 else (6, 5, 7)
    rho = rng.uniform(0.2, 0.3, (1, 1, *res)).astype(np.float32)
    vel = rng.uniform(-0.05, 0.05, (1, dim, *res)).astype(np.float32)
    a = tdiag.diagnostics(torch.from_numpy(rho), torch.from_numpy(vel))
    b = jdiag.diagnostics(jnp.asarray(rho), jnp.asarray(vel))
    assert sorted(a) == sorted(b)
    for k in ("mass", "kinetic_energy", "max_speed"):
        np.testing.assert_allclose(float(a[k]), float(b[k]), rtol=1e-6, err_msg=k)
    assert bool(a["finite"]) and bool(b["finite"])
    vel[0, 0, 1] = np.nan
    assert not bool(tdiag.diagnostics(torch.from_numpy(rho), torch.from_numpy(vel))["finite"])


def test_diagnostics_mass_of_uniform_rho():
    params, state = _single()
    d = tdiag.diagnostics(state.rho, state.vel)
    np.testing.assert_allclose(float(d["mass"]), 0.265 * 256, rtol=1e-5)
    assert float(d["max_speed"]) <= 0.05 * np.sqrt(2) + 1e-6


def _single():
    params = tm.SimulationParams(dim=2, tau=0.8)
    res = (16, 16)
    rng = np.random.default_rng(7)
    return params, tm.init_singlephase_state(
        params, np.full((1, 1, *res), 0.265, np.float32),
        rng.uniform(-0.05, 0.05, (1, 2, *res)).astype(np.float32),
        np.full((1, 1, *res), 1, np.uint8), device="cpu")


def test_step_timer_and_sync():
    params, state = _single()
    timer = profiling.StepTimer(sites=16 * 16)
    for _ in range(3):
        with timer:
            state = tm.singlephase_step(params, state, device="cpu")
        timer.sync(state)
    s = timer.summary()
    assert s["steps"] == 3 and s["seconds"] > 0 and s["mlups"] > 0
    assert trunner.sync(state) is state


def test_trace_writes_a_chrome_trace(tmp_path):
    params, state = _single()
    with profiling.trace(str(tmp_path / "t")):
        tm.singlephase_step(params, state, device="cpu")
    trace = json.loads((tmp_path / "t" / "trace.json").read_text())
    assert trace["traceEvents"]


def test_celltype_colormap_equal_jax():
    cm_t, fmt_t, norm_t, bins_t = ttypes.celltype_colormap()
    cm_j, fmt_j, norm_j, bins_j = jtypes.celltype_colormap()
    np.testing.assert_array_equal(bins_t, bins_j)
    assert list(cm_t.colors) == list(cm_j.colors)
    for v in (0, 1, 2, 4, 8, 16, 32, 64):
        assert fmt_t(v, None) == fmt_j(v, None)
    assert ttypes.CellType.get_colormap()[0].colors == cm_t.colors


@pytest.mark.parametrize("dim", [2, 3])
def test_field_shapes_equal_jax(dim):
    res = (9, 11) if dim == 2 else (4, 5, 6)
    from lbm_ferrofluid_tpu.models.state import field_shapes

    assert tstate.field_shapes(tm.SimulationParams(dim=dim), res, batch=2) == field_shapes(
        jm.SimulationParams(dim=dim), res, batch=2)


@pytest.mark.parametrize("dtype,bar", [(np.float32, 1e-6), (np.float64, 1e-12)])
def test_vorticity_2d_equal_jax(dtype, bar):
    vel = np.random.default_rng(3).normal(size=(2, 2, 9, 13)).astype(dtype)
    a = tmom.vorticity_2d(torch.from_numpy(vel), 0.5)
    b = np.asarray(jmom.vorticity_2d(jnp.asarray(vel), 0.5))
    assert a.shape == b.shape == (2, 1, 9, 13) and a.numpy().dtype == b.dtype
    np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=bar * np.abs(b).max())


def test_h_from_scalar_equal_jax():
    """The channel h rebuilt from a scalar carry, on the spike scene's
    magnetic flags with a random carry: the port's channels against JAX's
    at float32's rounding, and through ``compare_views`` the carry itself."""
    mflags = np.full((1, 1, 6, 7, 8), 1, np.uint8)
    mflags[..., 0, :, :] = mflags[..., -1, :, :] = 2
    mflags[..., :, :, 0] = mflags[..., :, :, -1] = 2
    rng = np.random.default_rng(4)
    fluid = (mflags != 2).astype(np.float32)
    s = rng.normal(size=mflags.shape).astype(np.float32) * fluid
    sp = rng.normal(size=mflags.shape).astype(np.float32) * fluid
    rhs = rng.normal(size=mflags.shape).astype(np.float32) * fluid
    for dt in ("float32", "bfloat16"):
        a = tsp.h_from_scalar(*map(torch.from_numpy, (s, sp, rhs, mflags)), dt)
        b = jsp.h_from_scalar(*map(jnp.asarray, (s, sp, rhs, mflags)), dt)
        assert str(a.dtype).endswith(dt)
        np.testing.assert_allclose(a.float().numpy(), np.asarray(b, np.float32), rtol=1e-6,
                                   atol=1e-7)
    h = tsp.h_from_scalar(*map(torch.from_numpy, (s, sp, rhs, mflags)), torch.float32)
    carry = torch.from_numpy(np.concatenate([s, sp], axis=1))
    va, vb = tsp.compare_views(carry, h, torch.from_numpy(mflags))
    torch.testing.assert_close(va, vb, rtol=1e-6, atol=1e-6)
