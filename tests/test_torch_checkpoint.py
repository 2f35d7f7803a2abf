"""Checkpoints of the port (``lbm_ferrofluid_tpu_torch/utils/checkpoint.py``)
against the JAX package's (``lbm_ferrofluid_tpu/utils/checkpoint.py``): the
same keys (``jax.tree_util.keystr`` names, premac tuple indices included),
a port checkpoint loading into a JAX template and a JAX checkpoint into a
port template, bfloat16 leaves stored widened to float32, resume stepping
as the original.

The two packages prime a ferrofluid state differently (ROADMAP §C
"Priming": on the CPU and on lane-unaligned grids the JAX package carries
the scalar h without a premac, the port a 6-leaf premac), so the
cross-package cases use states whose structure both share: un-primed
states, a premac tuple attached by hand as tests/test_runner.py does, and
the scalar carry (h with 2 channels and its cmask) without a premac."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_ferrofluid_tpu import models as jm
from lbm_ferrofluid_tpu.models import scenes as jscenes
from lbm_ferrofluid_tpu.utils import checkpoint as jck
from lbm_ferrofluid_tpu_torch import models as tm
from lbm_ferrofluid_tpu_torch.utils import checkpoint as tck


@pytest.fixture(autouse=True)
def _one_thread():
    """One PyTorch thread: the tier-1 run puts six test processes on the
    machine's cores, and PyTorch's default pool would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


RES3 = (8, 8, 8)


def _single(pkg, dev=None):
    params = pkg.SimulationParams(dim=2, tau=0.8)
    res = (16, 16)
    flags = np.full((1, 1, *res), 1, np.uint8)
    rho = np.full((1, 1, *res), 0.265, np.float32)
    vel = np.random.default_rng(7).uniform(-0.05, 0.05, (1, 2, *res)).astype(np.float32)
    kw = {} if dev is None else {"device": dev}
    return params, pkg.init_singlephase_state(params, rho, vel, flags, **kw)


def _ferro(pkg, dev=None, **extra):
    params = pkg.SimulationParams(
        dim=3, density_gas=0.02381, density_fluid=0.2508, rho_gas=0.02381, rho_fluid=0.2508,
        mag_strength=85.0, poisson_iters=3, **extra)
    flags = np.full((1, 1, *RES3), 2, np.uint8)
    flags[..., 1:-1, 1:-1, 1:-1] = 1
    mflags = np.full((1, 1, *RES3), 2, np.uint8)
    mflags[..., 1:-1, :, 1:-1] = 1
    rho = np.full((1, 1, *RES3), params.rho_gas, np.float32)
    den = np.full((1, 1, *RES3), params.density_gas, np.float32)
    rho[..., :4, :] = params.rho_fluid
    den[..., :4, :] = params.density_fluid
    kw = {} if dev is None else {"device": dev}
    return params, pkg.init_ferrofluid_state(
        params, rho, den, np.zeros((1, 3, *RES3), np.float32), flags, mflags, **kw)


def _assert_leaves_equal(port_state, jax_state):
    for key, leaf in tck.leaf_paths(port_state):
        want = eval("jax_state" + key)  # noqa: S307 - the key is an attribute path
        got = leaf.float() if torch.is_tensor(leaf) and leaf.dtype == torch.bfloat16 else leaf
        want = np.asarray(want, np.float32) if str(np.asarray(want).dtype) == "bfloat16" else want
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=key)


def test_roundtrip_and_resume(tmp_path):
    params, state = _single(tm, "cpu")
    for _ in range(3):
        state = tm.singlephase_step(params, state, device="cpu")
    tck.save_checkpoint(tmp_path / "c.npz", state)
    restored = tck.load_checkpoint(tmp_path / "c.npz", _single(tm, "cpu")[1])
    assert restored.step == 3 and isinstance(restored.step, int)
    torch.testing.assert_close(restored.f, state.f, rtol=0, atol=0)
    a = tm.singlephase_step(params, state, device="cpu")
    b = tm.singlephase_step(params, restored, device="cpu")
    torch.testing.assert_close(a.f, b.f, rtol=0, atol=0)


@pytest.mark.parametrize("case", ["single", "ferro", "ferro bf16 h", "hcz"])
def test_keys_equal_jax(tmp_path, case):
    if case == "single":
        tstate, jstate = _single(tm, "cpu")[1], _single(jm)[1]
    elif case == "hcz":
        tstate, jstate = (tm.multiphase_3d(RES3, device="cpu")[1], jscenes.multiphase_3d(RES3)[1])
    else:
        extra = {"h_dtype": "bfloat16"} if "bf16" in case else {}
        tstate, jstate = _ferro(tm, "cpu", **extra)[1], _ferro(jm, **extra)[1]
    jck.save_checkpoint(tmp_path / "j.npz", jstate)
    tck.save_checkpoint(tmp_path / "t.npz", tstate)
    jd, td = np.load(tmp_path / "j.npz"), np.load(tmp_path / "t.npz")
    assert sorted(td.files) == sorted(jd.files)
    for k in jd.files:
        assert td[k].dtype == jd[k].dtype and td[k].shape == jd[k].shape, k


def test_jax_checkpoint_loads_into_port(tmp_path):
    """A stepped JAX ferrofluid state with bfloat16 h and a premac tuple
    attached by hand (tests/test_runner.py:test_checkpoint_premac_tuple)."""
    params, js = _ferro(jm, h_dtype="bfloat16")
    js = jm.ferrofluid_step(params, js)
    premac = (js.rho, js.vel, js.density, jnp.sum(js.g, axis=1, keepdims=True),
              jnp.zeros_like(js.vel), jnp.zeros_like(js.rho))
    js = dataclasses.replace(js, premac=premac)
    jck.save_checkpoint(tmp_path / "j.npz", js)
    tp, ts = _ferro(tm, "cpu", h_dtype="bfloat16")
    template = ts.replace(premac=tuple(torch.zeros_like(x) for x in (
        ts.rho, ts.vel, ts.density, ts.rho, ts.vel, ts.rho)))
    got = tck.load_checkpoint(tmp_path / "j.npz", template)
    assert got.h.dtype == torch.bfloat16 and len(got.premac) == 6 and got.step == 1
    _assert_leaves_equal(got, js)
    # a fresh template (premac None): the premac leaves are not part of it
    plain = tck.load_checkpoint(tmp_path / "j.npz", ts)
    assert plain.premac is None
    _assert_leaves_equal(plain, dataclasses.replace(js, premac=None))


def test_port_checkpoint_loads_into_jax(tmp_path):
    tp, ts = _ferro(tm, "cpu", h_dtype="bfloat16")
    ts = tm.ferrofluid_step(tp, ts, device="cpu")
    ts = ts.replace(premac=(ts.rho, ts.vel, ts.density, ts.g.float().sum(1, keepdim=True),
                            torch.zeros_like(ts.vel), torch.zeros_like(ts.rho)))
    tck.save_checkpoint(tmp_path / "t.npz", ts)
    jp, js = _ferro(jm, h_dtype="bfloat16")
    template = dataclasses.replace(js, premac=tuple(jnp.zeros_like(x) for x in (
        js.rho, js.vel, js.density, js.rho, js.vel, js.rho)))
    got = jck.load_checkpoint(tmp_path / "t.npz", template)
    assert got.h.dtype == jnp.bfloat16 and int(got.step) == 1
    _assert_leaves_equal(ts, got)
    # the restored JAX state steps as the JAX step of the same values
    a = jm.ferrofluid_step(jp, dataclasses.replace(got, premac=None))
    assert np.isfinite(np.asarray(a.f)).all()


def test_scalar_carry_crosses(tmp_path):
    """The scalar carry (2-channel h, cmask) of the JAX package's priming
    on this grid loads into a port state of that structure and back."""
    jp, js = _ferro(jm)
    js = jm.prime_premac(jp, js)
    assert js.h.shape[1] == 2 and js.premac is None and js.cmask is not None
    jck.save_checkpoint(tmp_path / "j.npz", js)
    tp, ts = _ferro(tm, "cpu")
    template = ts.replace(h=torch.zeros((1, 2, *RES3)), cmask=torch.zeros((1, 1, *RES3)))
    got = tck.load_checkpoint(tmp_path / "j.npz", template)
    _assert_leaves_equal(got, js)
    tck.save_checkpoint(tmp_path / "t.npz", got)
    back = jck.load_checkpoint(tmp_path / "t.npz", js)
    _assert_leaves_equal(got, back)


def test_hcz_jax_to_port_and_back(tmp_path):
    jp, js = jscenes.multiphase_3d(RES3)
    js = jm.hcz_step(jp, js)
    jck.save_checkpoint(tmp_path / "j.npz", js)
    tp, ts = tm.multiphase_3d(RES3, device="cpu")
    got = tck.load_checkpoint(tmp_path / "j.npz", ts)
    _assert_leaves_equal(got, js)
    # resume: one port step of the loaded JAX state equals one JAX step at
    # float32's FMA level
    a = tm.hcz_step(tp, got, device="cpu")
    b = jm.hcz_step(jp, js)
    np.testing.assert_allclose(a.density.numpy(), np.asarray(b.density), rtol=5e-5, atol=1e-7)


def test_missing_leaf_raises(tmp_path):
    params, state = _single(tm, "cpu")
    tck.save_checkpoint(tmp_path / "c.npz", state)
    _, fs = _ferro(tm, "cpu")
    with pytest.raises(KeyError, match="missing leaf"):
        tck.load_checkpoint(tmp_path / "c.npz", fs)
