"""The port's render stack against the JAX package's: host marching
tetrahedra and marching cubes bit for bit, camera and lighting at 1e-6,
the soft rasterizer's image at abs 1e-5 (every aggregation mode, texture
type and ``fill_back``), its tiled pass against its dense pass, its
gradient against JAX's at 1e-4 relative, ``SoftRenderer`` and the
phi -> frame helpers (render_phi_frame's pipeline path raises past its
triangle budget)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_ferrofluid_tpu import render as jr
from lbm_ferrofluid_tpu.render import mcubes as jmc
from lbm_ferrofluid_tpu.render import mesh as jmesh
from lbm_ferrofluid_tpu.render import softras as jsr
from lbm_ferrofluid_tpu_torch import render as tr
from lbm_ferrofluid_tpu_torch.render import mcubes as tmc
from lbm_ferrofluid_tpu_torch.render import mesh as tmesh
from lbm_ferrofluid_tpu_torch.render import softras as tsr


@pytest.fixture(autouse=True)
def _one_thread():
    """One PyTorch thread: the tier-1 run puts six test processes on the
    machine's cores, and PyTorch's default pool would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


IMAGE_ABS = 1e-5


@pytest.fixture
def host_mesh(monkeypatch):
    """Both packages' host extractors on their numpy paths (no native twin:
    it emits the same triangles in another order)."""
    import lbm_ferrofluid_tpu.native as native
    import lbm_ferrofluid_tpu_torch.native as tnative

    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setattr(tnative, "available", lambda: False)


def _volumes():
    rng = np.random.default_rng(7)
    n, r = 24, 8.0
    c = (n - 1) / 2
    i, j, k = np.mgrid[0:n, 0:n, 0:n]
    sphere = np.sqrt((i - c) ** 2 + (j - c) ** 2 + (k - c) ** 2) - r
    ax = (np.arange(28) + 0.5) / 28 - 0.5
    Z, Y, X = np.meshgrid(ax, ax, ax, indexing="ij")
    blob = np.sqrt(X**2 + Y**2 + Z**2) - 0.35 + 0.02 * rng.normal(size=X.shape)
    return {"sphere": sphere, "blob": blob, "empty": np.ones((8, 8, 8)),
            "noise": rng.normal(size=(9, 7, 11))}


@pytest.mark.parametrize("name", ["sphere", "blob", "empty", "noise"])
def test_marching_tetrahedra_bit_for_bit(host_mesh, name):
    vol = _volumes()[name]
    vj, fj = jmesh.marching_tetrahedra(vol, 0.0)
    vt, ft = tmesh.marching_tetrahedra(vol, 0.0)
    assert vt.dtype == vj.dtype and ft.dtype == fj.dtype
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_array_equal(ft, fj)


@pytest.mark.parametrize("name", ["sphere", "blob", "noise"])
def test_marching_cubes_bit_for_bit(name):
    vol = _volumes()[name]
    np.testing.assert_array_equal(tmc.MC_TRI_TABLE, jmc.MC_TRI_TABLE)
    vj, fj = jmc.marching_cubes_classic(vol, 0.0)
    vt, ft = tmc.marching_cubes_classic(vol, 0.0)
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_array_equal(ft, fj)
    vt2, ft2 = tmesh.marching_cubes(vol, 0.0)
    np.testing.assert_array_equal(vt2, vj)
    np.testing.assert_array_equal(ft2, fj)


@pytest.mark.parametrize("method", ["mt", "mc"])
def test_phi_to_mesh_bit_for_bit(host_mesh, method):
    n = 16
    i, j, k = np.mgrid[0:n, 0:n, 0:n]
    dist = np.sqrt((i - n / 2) ** 2 + (j - n / 2) ** 2 + (k - n / 2) ** 2)
    phi = np.tanh((dist - 5.0) / 2.0)[None, None].astype(np.float32)
    vj, fj = jr.phi_to_mesh(phi, (n, n, n), 1.0, method=method)
    vt, ft = tr.phi_to_mesh(torch.from_numpy(phi), (n, n, n), 1.0, method=method)
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_array_equal(ft, fj)


def _j(x):
    return np.asarray(x)


def test_camera_against_jax():
    rng = np.random.default_rng(0)
    v = rng.normal(size=(2, 10, 3)).astype(np.float32)
    vt = torch.from_numpy(v)
    eye = np.asarray([1.6, 0.8, 1.6], np.float32)
    np.testing.assert_allclose(tr.look_at(vt, eye).numpy(),
                               _j(jr.look_at(jnp.asarray(v), jnp.asarray(eye))), atol=1e-6)
    d = np.asarray([-0.7, 0.1, -0.7], np.float32)
    np.testing.assert_allclose(tr.look(vt, eye, d).numpy(),
                               _j(jr.look(jnp.asarray(v), jnp.asarray(eye), jnp.asarray(d))),
                               atol=1e-6)
    vz = v + np.asarray([0, 0, 4.0], np.float32)
    np.testing.assert_allclose(tr.perspective_distortion(torch.from_numpy(vz), 45.0).numpy(),
                               _j(jr.perspective_distortion(jnp.asarray(vz), 45.0)), rtol=1e-6)
    faces = rng.integers(0, 10, size=(2, 7, 3))
    np.testing.assert_array_equal(tr.vertices_to_faces(vt, torch.from_numpy(faces)).numpy(),
                                  _j(jr.vertices_to_faces(jnp.asarray(v), jnp.asarray(faces))))
    np.testing.assert_allclose(tr.eye_from_angles(2.5, 20.0, 30.0).numpy(),
                               _j(jr.eye_from_angles(2.5, 20.0, 30.0)), atol=1e-6)


def test_camera_on_axis_and_distances():
    out = tr.look_at(torch.zeros(1, 1, 3), [0.0, 0.0, -3.0])
    np.testing.assert_allclose(out.numpy()[0, 0], [0, 0, 3], atol=1e-6)
    rng = np.random.default_rng(0)
    v = torch.from_numpy(rng.normal(size=(1, 10, 3)).astype(np.float32))
    out = tr.look_at(v, [1.6, 0.8, 1.6])
    d_in = torch.linalg.norm(v[0, :1] - v[0, 1:], dim=-1)
    d_out = torch.linalg.norm(out[0, :1] - out[0, 1:], dim=-1)
    np.testing.assert_allclose(d_in.numpy(), d_out.numpy(), rtol=1e-5)


@pytest.mark.parametrize("direction", [[0.0, 0.0, 1.0], [0.0, 0.0, -1.0], [0.3, 0.9, 0.1]])
def test_lighting_against_jax(direction):
    rng = np.random.default_rng(1)
    fv = rng.normal(size=(2, 6, 3, 3)).astype(np.float32)
    tex = rng.uniform(size=(2, 6, 4, 3)).astype(np.float32)
    d = np.asarray(direction, np.float32)
    for fn in ("compute_ambient_light", "apply_ambient_light"):
        a = getattr(tr, fn)(torch.from_numpy(fv), torch.from_numpy(tex), 0.5)
        b = getattr(jr, fn)(jnp.asarray(fv), jnp.asarray(tex), 0.5)
        np.testing.assert_allclose(a.numpy(), _j(b), atol=1e-6)
    for fn in ("compute_directional_light", "apply_directional_light"):
        a = getattr(tr, fn)(torch.from_numpy(fv), torch.from_numpy(tex), 0.8, direction=d)
        b = getattr(jr, fn)(jnp.asarray(fv), jnp.asarray(tex), 0.8,
                            direction=jnp.asarray(d))
        np.testing.assert_allclose(a.numpy(), _j(b), atol=1e-6)


def _mesh(F, seed=0, spread=1.1, size=0.3, T=4):
    """F random faces in screen space and their textures, float64.

    The comparisons with JAX run in float64.  In float32 the two packages
    round apart by the ulp of ``face_sym`` (p . p + 1), which the sigmoid
    at sigma 1e-3 amplifies to 3e-5 in alpha (XLA contracts the
    barycentric sums into FMAs, PyTorch does not).  With a 2x2 surface
    texture (T = 4) a pixel whose third clipped barycentric is 0 picks
    texel 1 or 2 on the sign of a rounding error, since
    (w0 + w1) R - wx - wy <= 1 holds with equality there (the reference
    kernel's rule, soft_rasterize_cuda_kernel.cu:195-214): those two
    texels are given one color, so the test holds the rule everywhere
    else."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-spread, spread, (1, F, 1, 3))
    fv = c + rng.uniform(-size, size, (1, F, 3, 3))
    fv[..., 2] = rng.uniform(5.0, 20.0, (1, F, 3))
    tex = rng.uniform(0, 1, (1, F, T, 3))
    if T == 4:
        tex[..., 2, :] = tex[..., 1, :]
    return fv, tex


RASTER_CASES = [
    dict(),
    dict(aggr_func_alpha="sum"),
    dict(aggr_func_alpha="hard"),
    dict(aggr_func_rgb="hard"),
    dict(dist_func="barycentric"),
    dict(dist_func="hard", aggr_func_rgb="hard", aggr_func_alpha="hard"),
    dict(texture_type="vertex", T=3),
    dict(fill_back=False),
    dict(fill_back=False, aggr_func_rgb="hard"),
    dict(image_size=64, sigma_val=1e-4, background_color=[1.0, 1.0, 1.0]),
]


@pytest.mark.parametrize("case", range(len(RASTER_CASES)))
def test_soft_rasterize_against_jax(case):
    kw = dict(RASTER_CASES[case])
    T = kw.pop("T", 4)
    kw.setdefault("image_size", 32)
    kw.setdefault("sigma_val", 1e-3)
    fv, tex = _mesh(24, seed=case, T=T)
    a = tsr.soft_rasterize(torch.from_numpy(fv), torch.from_numpy(tex), **kw)
    b = jsr.soft_rasterize(jnp.asarray(fv), jnp.asarray(tex), **kw)
    assert a.shape == (1, 4, kw["image_size"], kw["image_size"])
    np.testing.assert_allclose(a.numpy(), _j(b), atol=IMAGE_ABS, rtol=0)


def test_soft_rasterize_coverage():
    tri = torch.tensor([[[[-0.5, -0.5, 2.0], [0.5, -0.5, 2.0], [0.0, 0.5, 2.0]]]])
    tex = torch.full((1, 1, 2, 3), 0.7)
    img = tsr.soft_rasterize(tri, tex, image_size=32, dist_func="hard",
                             aggr_func_rgb="hard", aggr_func_alpha="hard").numpy()
    np.testing.assert_allclose(img[0, :3, 16, 16], 0.7, atol=1e-6)
    np.testing.assert_allclose(img[0, :3, 0, 0], 0.0, atol=1e-6)
    assert img[0, 3, 16, 16] == 1.0 and img[0, 3, 0, 0] == 0.0
    S = 64
    y_edge = 1.0 / S
    edge = torch.tensor([[[[-0.9, y_edge, 2.0], [0.9, y_edge, 2.0], [0.0, -0.9, 2.0]]]])
    img = tsr.soft_rasterize(edge, tex, image_size=S, sigma_val=1e-5, aggr_func_alpha="sum")
    assert 0.45 < float(img[0, 3, 31, 32]) < 0.55


TILED_CASES = [
    dict(),
    dict(aggr_func_rgb="hard", aggr_func_alpha="sum", dist_func="barycentric"),
    dict(aggr_func_alpha="hard", dist_func="hard"),
]


def _tiled_mesh():
    """240 small faces, 12 of them with bboxes over 4 tiles (the residual
    list), at S = 64 with buckets of 64 faces (some overflow)."""
    fv, tex = _mesh(240, seed=3, size=0.05)
    fv[0, :12, :, :2] *= 8.0
    return fv, tex


@pytest.mark.parametrize("case", range(len(TILED_CASES)))
def test_tiled_matches_dense(case):
    fv, tex = _tiled_mesh()
    args = (torch.from_numpy(fv), torch.from_numpy(tex))
    kw = TILED_CASES[case]
    dense = tsr.soft_rasterize(*args, image_size=64, tiled=False, **kw)
    tiled = tsr.soft_rasterize(*args, image_size=64, tiled=True, tile_bucket=64, **kw)
    np.testing.assert_allclose(tiled.numpy(), dense.numpy(), rtol=1e-6, atol=1e-7)


@pytest.mark.slow
@pytest.mark.parametrize("case", range(len(TILED_CASES)))
def test_tiled_against_jax_tiled(case):
    fv, tex = _tiled_mesh()
    kw = dict(TILED_CASES[case], image_size=64, tiled=True, tile_bucket=64)
    a = tsr.soft_rasterize(torch.from_numpy(fv), torch.from_numpy(tex), **kw)
    b = jsr.soft_rasterize(jnp.asarray(fv), jnp.asarray(tex), **kw)
    np.testing.assert_allclose(a.numpy(), _j(b), atol=IMAGE_ABS, rtol=0)


@pytest.mark.slow
def test_tiled_auto_rule():
    """The auto rule engages at 2048 faces and S >= 64 (the JAX module's);
    the tiled image equals the dense one."""
    fv, tex = _mesh(2048, seed=4, size=0.03)
    args = (torch.from_numpy(fv), torch.from_numpy(tex))
    auto = tsr.soft_rasterize(*args, image_size=64)
    dense = tsr.soft_rasterize(*args, image_size=64, tiled=False)
    np.testing.assert_allclose(auto.numpy(), dense.numpy(), rtol=1e-6, atol=1e-7)


def test_zero_area_faces_dropped():
    """A face with two corners on one point contributes nothing (the JAX
    module meets its distances as NaN and drops it)."""
    fv, tex = _mesh(6, seed=8)
    deg = fv.copy()
    deg[0, 2, 2] = deg[0, 2, 1]
    a = tsr.soft_rasterize(torch.from_numpy(deg), torch.from_numpy(tex), image_size=32)
    keep = [0, 1, 3, 4, 5]
    b = tsr.soft_rasterize(torch.from_numpy(fv[:, keep]), torch.from_numpy(tex[:, keep]),
                           image_size=32)
    np.testing.assert_allclose(a[:, :3].numpy(), b[:, :3].numpy(), atol=1e-12)
    np.testing.assert_allclose(a[:, 3].numpy(), b[:, 3].numpy(), atol=1e-12)
    c = jsr.soft_rasterize(jnp.asarray(deg), jnp.asarray(tex), image_size=32)
    np.testing.assert_allclose(a.numpy(), _j(c), atol=IMAGE_ABS, rtol=0)


def test_gradient_against_jax():
    fv = np.asarray([[[[-0.5, -0.5, 10.0], [0.5, -0.5, 10.0], [0.0, 0.6, 12.0]],
                      [[-0.2, -0.7, 11.0], [0.7, 0.1, 11.0], [0.1, 0.5, 9.0]]]], np.float64)
    tex = np.random.default_rng(2).uniform(size=(1, 2, 4, 3))

    def jloss(fv_, tex_):
        img = jsr.soft_rasterize(fv_, tex_, image_size=16, sigma_val=1e-2, remat=False)
        return jnp.sum(img[:, :3] ** 2) + jnp.sum(img[:, 3])

    gj = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(fv), jnp.asarray(tex))
    ft = torch.tensor(fv, requires_grad=True)
    tt = torch.tensor(tex, requires_grad=True)
    img = tsr.soft_rasterize(ft, tt, image_size=16, sigma_val=1e-2)
    (torch.sum(img[:, :3] ** 2) + torch.sum(img[:, 3])).backward()
    for a, b in ((ft.grad, gj[0]), (tt.grad, gj[1])):
        b = _j(b)
        assert np.isfinite(a.numpy()).all() and np.abs(b).max() > 0
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=1e-4 * np.abs(b).max())


def test_remat_gradient_equals_plain():
    """Checkpointed chunk groups (more than 32 chunks) give the gradient
    of the plain loop."""
    fv, tex = _mesh(300, seed=5, size=0.2)
    grads = []
    for remat in (True, False):
        ft = torch.tensor(fv, dtype=torch.float64, requires_grad=True)
        img = tsr.soft_rasterize(ft, torch.from_numpy(tex).double(), image_size=16,
                                 sigma_val=1e-2, face_chunk=8, remat=remat)
        torch.sum(img * img).backward()
        grads.append(ft.grad)
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-10, atol=1e-12)


def _renderers(**kw):
    """The port's and JAX's renderer, compared in float64 (see ``_mesh``)."""
    return (tr.SoftRenderer(device="cpu", **kw),
            jr.SoftRenderer(**{k: (jnp.asarray(v, jnp.float64) if isinstance(v, np.ndarray)
                                   else v) for k, v in kw.items()}))


@pytest.mark.parametrize("mode", ["look_at", "look", "projection"])
def test_soft_renderer_against_jax(mode):
    kw = dict(image_size=16, camera_mode=mode)
    if mode == "projection":
        K = np.eye(4, dtype=np.float32)
        K[0, 0] = K[1, 1] = 2.0
        kw.update(K=K, rmat=np.eye(4, dtype=np.float32),
                  tvec=np.asarray([0.0, 0.0, -3.0], np.float32))
    if mode == "look":
        kw.update(eye=np.asarray([0.0, 0.0, -3.0], np.float32),
                  camera_direction=np.asarray([0.0, 0.0, 1.0], np.float32))
    rt, rj = _renderers(**kw)
    verts = np.asarray([[[-0.5, -0.5, 0.0], [0.5, -0.5, 0.0], [0.0, 0.5, 0.2]]])
    faces = np.asarray([[[0, 1, 2]]])
    tex = np.full((1, 1, 2, 3), 0.7)
    a = rt.forward(torch.from_numpy(verts), torch.from_numpy(faces), torch.from_numpy(tex))
    b = rj.forward(jnp.asarray(verts), jnp.asarray(faces), jnp.asarray(tex))
    np.testing.assert_allclose(a.numpy(), _j(b), atol=IMAGE_ABS, rtol=0)
    assert float(a[0, 3].max()) > 0.5


def test_set_eye_from_angles():
    r = tr.SoftRenderer(image_size=16, device="cpu")
    r.set_eye_from_angles(2.5, 20.0, 30.0)
    assert abs(float(torch.linalg.norm(r.eye)) - 2.5) < 1e-5


def _sphere_phi(n=10, radius=3.0):
    i, j, k = np.mgrid[0:n, 0:n, 0:n]
    dist = np.sqrt((i - n / 2) ** 2 + (j - n / 2) ** 2 + (k - n / 2) ** 2)
    return np.tanh((dist - radius) / 2.0)[None, None].astype(np.float32)


def _png(path):
    from PIL import Image

    return np.asarray(Image.open(path))


def jax_frame(phi, filename, res, image_size):
    """The JAX package's ``render_phi_frame`` image of phi, with the mesh's
    zero-area faces left out.  Marching tetrahedra emits such faces where
    an edge crossing falls on a node (two corners on one point); the JAX
    rasterizer meets their distances as rounding noise of its determinant
    clamp, dropped where it is NaN and drawn as a spot where it is finite,
    while the port's rasterizer drops every one of them
    (``test_zero_area_faces_dropped``)."""
    verts, faces = jr.phi_to_mesh(phi, res)
    tri = verts[faces]
    keep = np.linalg.norm(np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]), axis=1) > 0
    vb, fb = jr._bucket_mesh(verts, faces[keep])
    renderer = jr.default_renderer(image_size)
    out = renderer.forward(jnp.asarray(vb)[None], jnp.asarray(fb)[None],
                           jnp.full((1, fb.shape[0], 2, 3), 0.68, jnp.float32))
    img = (np.clip(np.asarray(out[0, :3]).transpose(1, 2, 0), 0, 1) * 255).astype(np.uint8)
    from PIL import Image

    Image.fromarray(img).save(filename)
    return verts, faces


def test_render_phi_frame_against_jax(tmp_path, host_mesh):
    """The host path's frame of a sphere within one gray level of the JAX
    package's, with the same mesh."""
    phi = _sphere_phi()
    res = (10, 10, 10)
    vt, ft = tr.render_phi_frame(torch.from_numpy(phi), str(tmp_path / "t.png"), res,
                                 renderer=tr.default_renderer(16, device="cpu"))
    vj, fj = jax_frame(phi, str(tmp_path / "j.png"), res, 16)
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_array_equal(ft, fj)
    a, b = _png(tmp_path / "t.png"), _png(tmp_path / "j.png")
    assert a.shape == b.shape == (16, 16, 3)
    assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
    assert a[6:10, 6:10].min() < 200 and a[0, 0].min() >= 250


def test_render_pipeline_close_to_host(tmp_path):
    """phi -> device mesh -> image against the host path, at the bars of
    tests/test_mesh_jax.py (mean abs < 2e-3, max < 0.1)."""
    phi = torch.from_numpy(_sphere_phi())
    res = (10, 10, 10)
    renderer = tr.default_renderer(16, device="cpu")
    pipe = tr.make_render_pipeline(res, renderer=renderer, budget=1 << 12, device="cpu")
    img_d, count = pipe(phi)
    assert int(count) <= 1 << 12
    v, f = tr.phi_to_mesh(phi, res)
    vb, fb = tr._bucket_mesh(v, f)
    img_h = tr._image(renderer, torch.from_numpy(vb), torch.from_numpy(fb), 0.68)
    d = (img_d - img_h).abs()
    assert float(d.mean()) < 2e-3 and float(d.max()) < 0.1
    out = tmp_path / "pipe.png"
    assert tr.render_phi_frame(phi, str(out), res, pipeline=pipe) == (None, None)
    assert _png(out).shape == (16, 16, 3)


def test_render_pipeline_raises_over_budget(tmp_path):
    phi = torch.from_numpy(_sphere_phi())
    pipe = tr.make_render_pipeline((10, 10, 10), renderer=tr.default_renderer(8, device="cpu"),
                                   budget=64, device="cpu")
    with pytest.raises(RuntimeError, match="budget of 64"):
        tr.render_phi_frame(phi, str(tmp_path / "x.png"), (10, 10, 10), pipeline=pipe)
    assert not (tmp_path / "x.png").exists()


def test_default_renderer_matches_jax():
    rt, rj = tr.default_renderer(device="cpu"), jr.default_renderer()
    for name in ("eye", "camera_direction", "bg_color", "light_direction"):
        np.testing.assert_allclose(getattr(rt, name).numpy(), _j(getattr(rj, name)), atol=1e-7)
    assert (rt.image_size, rt.near, rt.camera_mode) == (rj.image_size, rj.near, rj.camera_mode)
    assert math.isclose(rt.viewing_angle, rj.viewing_angle)
