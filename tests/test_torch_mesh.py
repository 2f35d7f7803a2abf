"""On-device marching tetrahedra (``lbm_ferrofluid_tpu_torch/render/
mesh_torch.py``) against the host extractor and the JAX package's
``render/mesh_jax.py``, as tests/test_mesh_jax.py holds the JAX one: the
same triangle set, the count reported past the budget, far-away
degenerate pad rows, the static topology, and ``phi_to_mesh_torch``
against host ``phi_to_mesh``."""

import numpy as np
import pytest
import torch

from lbm_ferrofluid_tpu.render.mesh_jax import marching_tetrahedra_jax
from lbm_ferrofluid_tpu_torch.render import phi_to_mesh
from lbm_ferrofluid_tpu_torch.render import mesh_torch
from lbm_ferrofluid_tpu_torch.render.mesh import marching_tetrahedra
from lbm_ferrofluid_tpu_torch.render.mesh_torch import (
    MT_FAR,
    marching_tetrahedra_torch,
    phi_to_mesh_torch,
)


@pytest.fixture(autouse=True)
def _one_thread():
    """One PyTorch thread: the tier-1 run puts six test processes on the
    machine's cores, and PyTorch's default pool would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _canon(tris, decimals=3):
    """Order-independent canonical form of a triangle soup."""
    t = np.round(np.asarray(tris, np.float64), decimals)
    return sorted(tuple(np.concatenate(sorted(map(tuple, tri)))) for tri in t)


def _volume(seed=0, shape=(14, 12, 16)):
    rng = np.random.default_rng(seed)
    D, H, W = shape
    z, y, x = np.meshgrid(np.arange(D), np.arange(H), np.arange(W), indexing="ij")
    vol = (z - D / 2.0) ** 2 / 20 + (y - H / 2.0) ** 2 / 14 + (x - W / 2.0) ** 2 / 25 - 1.0
    return vol + 0.05 * rng.normal(size=vol.shape)


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("group", [None, 1])
def test_device_matches_host_triangle_set(monkeypatch, seed, group):
    """``group`` 1 takes one cell layer at a time (the default several)."""
    if group:
        monkeypatch.setattr(mesh_torch, "GROUP_CANDIDATES", 1)
    vol = _volume(seed)
    v_h, f_h = marching_tetrahedra(vol, 0.0)
    v_d, f_d, cnt = marching_tetrahedra_torch(torch.from_numpy(vol.astype(np.float32)), 0.0,
                                              budget=1 << 13)
    cnt = int(cnt)
    assert cnt == len(f_h)
    tri_d = v_d.numpy().reshape(-1, 3, 3)[:cnt]
    ch, cd = _canon(v_h[f_h]), _canon(tri_d)
    assert len(ch) == len(cd)
    for a, b in zip(ch, cd):
        np.testing.assert_allclose(a, b, atol=2e-3)
    rest = v_d.numpy().reshape(-1, 3, 3)[cnt:]
    assert (rest == MT_FAR).all()
    np.testing.assert_array_equal(f_d.numpy(), np.arange((1 << 13) * 3).reshape(-1, 3))


def test_device_equals_jax_device():
    """The same rows, in the same order, as the JAX package's extractor."""
    vol = _volume(5).astype(np.float32)
    v_t, _, c_t = marching_tetrahedra_torch(torch.from_numpy(vol), 0.0, budget=1 << 13)
    v_j, _, c_j = marching_tetrahedra_jax(vol, 0.0, budget=1 << 13)
    assert int(c_t) == int(c_j)
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), rtol=0, atol=1e-5)


def test_budget_overflow_reported():
    vol = _volume(1)
    _, f_h = marching_tetrahedra(vol, 0.0)
    v_d, _, cnt = marching_tetrahedra_torch(torch.from_numpy(vol), 0.0, budget=64)
    assert int(cnt) == len(f_h)  # the true count, past the budget
    tri = v_d.numpy().reshape(-1, 3, 3)
    assert (tri != MT_FAR).any(axis=(1, 2)).sum() == 64  # the budget's rows filled


def test_empty_volume():
    v, f, cnt = marching_tetrahedra_torch(torch.ones(6, 6, 6), 0.0, budget=16)
    assert int(cnt) == 0 and (v == MT_FAR).all() and f.shape == (16, 3)


def test_phi_pipeline_matches_host_mesh():
    res = (12, 10, 14)
    vol = _volume(2, res)
    phi = np.tanh(-vol)[None, None].astype(np.float32)
    v_h, f_h = phi_to_mesh(phi, res)
    v_d, _, cnt = phi_to_mesh_torch(torch.from_numpy(phi), res, budget=1 << 13)
    cnt = int(cnt)
    assert cnt == len(f_h)
    tri_d = v_d.numpy().reshape(-1, 3, 3)[:cnt]
    for a, b in zip(_canon(v_h[f_h], 3), _canon(tri_d, 3)):
        np.testing.assert_allclose(a, b, atol=2e-3)
    # the pad rows normalize to (0, 0, MT_FAR): beyond the far plane
    pad = v_d.numpy().reshape(-1, 3, 3)[cnt:]
    np.testing.assert_allclose(pad[..., :2], 0.0, atol=1e-6)
    np.testing.assert_allclose(pad[..., 2], MT_FAR, rtol=1e-6)
