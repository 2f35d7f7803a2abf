"""The port's voxelizer and texture-atlas loader
(``lbm_ferrofluid_tpu_torch/render/voxelize.py``, ``texture.py``) against
the JAX package's on the CPU: voxel grids equal (surface, vertices, the
interior fill and the whole pipeline, on a sphere mesh, a seeded blob
mesh, the axis-aligned box of tests/test_voxelize_texture.py and a hollow
shell); textures within 1e-12 in float64 (with and without
``is_update``), and tests/test_voxelize_texture.py's own checks on the
port.

The grids are compared in float64 on meshes with float32 coordinates:
XLA on the CPU contracts the column test's ``a*b - c*d`` into a fused
multiply-add, which in float32 turns the zero determinant of a face seen
edge-on into +-5e-11 (a hit where the port, rounding each product, sees
none); in float64 those products are exact, so both give the same bits.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lbm_ferrofluid_tpu_torch.render.mesh import marching_tetrahedra  # noqa: E402

# render/__init__ re-exports the functions ``voxelize`` and ``load_textures``
# over their modules' names
jtex = importlib.import_module("lbm_ferrofluid_tpu.render.texture")
jvox = importlib.import_module("lbm_ferrofluid_tpu.render.voxelize")
ttex = importlib.import_module("lbm_ferrofluid_tpu_torch.render.texture")
tvox = importlib.import_module("lbm_ferrofluid_tpu_torch.render.voxelize")


@pytest.fixture(autouse=True)
def _one_thread():
    """One PyTorch thread: the tier-1 run puts six test processes on the
    machine's cores, and PyTorch's default pool would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _box_mesh(lo, hi):
    """12-triangle axis-aligned box with (y, x, z) components."""
    corners = np.array([[a, b, c] for a in (lo, hi) for b in (lo, hi) for c in (lo, hi)],
                       np.float64)
    quads = [(0, 1, 3, 2), (4, 5, 7, 6), (0, 1, 5, 4), (2, 3, 7, 6), (0, 2, 6, 4),
             (1, 3, 7, 5)]
    tris = []
    for a, b, c, d in quads:
        tris += [[corners[a], corners[b], corners[c]], [corners[a], corners[c], corners[d]]]
    return np.asarray(tris)[None]


def _iso_mesh(vs, kind, seed=0):
    c = vs / 2
    i, j, k = np.mgrid[0:vs, 0:vs, 0:vs]
    vol = np.sqrt((i - c) ** 2 + (j - c) ** 2 + (k - c) ** 2) - vs / 3.2
    if kind == "blob":
        vol = vol + 0.8 * np.random.default_rng(seed).normal(size=vol.shape)
    verts, faces = marching_tetrahedra(vol, 0.0)
    return verts[faces][None].astype(np.float64)  # [1, F, 3, 3], float32 values


MESHES = {"sphere": lambda: _iso_mesh(16, "sphere"), "blob": lambda: _iso_mesh(18, "blob"),
          "box": lambda: _box_mesh(4.0, 11.0)}


@pytest.mark.parametrize("name", sorted(MESHES))
def test_voxel_grids_equal_jax(name):
    faces = MESHES[name]()
    vs = 16 if name != "blob" else 18
    ft, fj = torch.from_numpy(faces), jnp.asarray(faces)
    surf_t = tvox.voxelize_surface(ft, vs, face_chunk=7)
    surf_j = np.asarray(jvox.voxelize_surface(fj, vs))
    assert surf_j.sum() > 50
    np.testing.assert_array_equal(surf_t.numpy(), surf_j)
    np.testing.assert_array_equal(tvox.voxelize_vertices(ft, vs).numpy(),
                                  np.asarray(jvox.voxelize_vertices(fj, vs)))
    solid_t = tvox.voxelize(ft, vs)
    assert solid_t.dtype == torch.int32
    np.testing.assert_array_equal(solid_t.numpy(), np.asarray(jvox.voxelize(fj, vs)))
    unit = faces / (vs - 1)
    np.testing.assert_array_equal(
        tvox.voxelize(torch.from_numpy(unit), vs, normalize=True).numpy(),
        np.asarray(jvox.voxelize(jnp.asarray(unit), vs, normalize=True)))


def test_empty_mesh_equals_jax():
    faces = np.zeros((1, 0, 3, 3))
    np.testing.assert_array_equal(tvox.voxelize(torch.from_numpy(faces), 6).numpy(),
                                  np.asarray(jvox.voxelize(jnp.asarray(faces), 6)))


def test_sphere_solid_and_hollow_surface():
    """tests/test_voxelize_texture.py's checks, on the port."""
    vox = tvox.voxelize(torch.from_numpy(_iso_mesh(16, "sphere")), 16).numpy()
    assert vox[0, 8, 8, 8] == 1 and vox[0, 1, 1, 1] == 0
    assert 300 < vox.sum() < 1200
    surf = tvox.voxelize_surface(torch.from_numpy(_box_mesh(4.0, 11.0)), 16).numpy()
    assert surf[0, 7, 7, 7] == 0 and surf.sum() > 100


def test_fill_interior_closed_cavity_equals_jax():
    shell = np.zeros((2, 8, 8, 8), np.int32)
    shell[:, 2:6, 2:6, 2:6] = 1
    shell[:, 3:5, 3:5, 3:5] = 0
    shell[1, 4, 4, 5] = 1  # a second batch entry that differs
    solid = tvox.fill_interior(torch.from_numpy(shell)).numpy()
    np.testing.assert_array_equal(solid, np.asarray(jvox.fill_interior(jnp.asarray(shell))))
    assert solid[0, 3, 3, 3] == 1 and solid[0, 0, 0, 0] == 0


@pytest.mark.parametrize("res", [1, 2, 5])
def test_textures_match_jax(res):
    rng = np.random.default_rng(res)
    img = rng.uniform(0, 1, (9, 13, 3))
    uv = rng.uniform(0, 1, (11, 3, 2))
    upd = rng.uniform(size=11) > 0.3
    for is_update in (None, upd):
        a = ttex.load_textures(torch.from_numpy(img), torch.from_numpy(uv), res, is_update)
        b = jtex.load_textures(jnp.asarray(img), jnp.asarray(uv), res, is_update)
        assert a.shape == (11, res * res, 3) and a.dtype == torch.float64
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-12)
    assert (a.numpy()[~upd] == 0).all()


def test_textures_constant_and_gradient_images():
    """tests/test_voxelize_texture.py's checks, on the port."""
    img = torch.full((8, 8, 3), 0.25)
    uv = torch.tensor([[[0.1, 0.1], [0.9, 0.1], [0.5, 0.9]]])
    np.testing.assert_allclose(ttex.load_textures(img, uv, 4).numpy(), 0.25, rtol=1e-6)
    ramp = torch.linspace(0, 1, 32)[None, :, None].expand(32, 32, 3).contiguous()
    left = torch.tensor([[[0.0, 0.5], [0.1, 0.5], [0.05, 0.6]]])
    right = torch.tensor([[[0.9, 0.5], [1.0, 0.5], [0.95, 0.6]]])
    assert ttex.load_textures(ramp, left, 2).mean() < 0.2
    assert ttex.load_textures(ramp, right, 2).mean() > 0.8
