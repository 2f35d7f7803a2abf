"""The port's DIB-R renderer (``lbm_ferrofluid_tpu_torch/render/dibr.py``)
against the JAX package's (``lbm_ferrofluid_tpu/render/dibr.py``) on the
CPU, in float64:

* a seeded, perturbed icosphere in all four modes (vertex color,
  Lambertian with nearest and bilinear sampling, spherical harmonics,
  Phong): images, probability maps and normals within 1e-9, and the
  z-buffer's winning face at every pixel equal (rasterized with the face
  index as the feature);
* the tiled pass (faces culled by 32- and 8-pixel tiles) against the
  dense one within 1e-12, and both against JAX;
* tests/test_dibr.py's ``TestKnum`` cases: the first ``knum`` candidates
  in face-index order, the dense ``knum=None`` limit, against JAX and as
  that file checks them;
* vertex gradients of an image loss against ``jax.grad`` within 1e-8;
* the camera helpers and ``tex_interpolation`` against JAX.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lbm_ferrofluid_tpu.render import dibr as jd  # noqa: E402

from lbm_ferrofluid_tpu_torch.render import dibr as td  # noqa: E402

BAR, GRAD_BAR = 1e-9, 1e-8


@pytest.fixture(autouse=True)
def _one_thread():
    """One PyTorch thread: the tier-1 run puts six test processes on the
    machine's cores, and PyTorch's default pool would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def icosphere(subdiv=2, seed=0, jitter=0.03):
    """An icosahedron subdivided ``subdiv`` times on the unit sphere, its
    vertices moved by seeded noise: outward-wound faces."""
    t = (1 + 5 ** 0.5) / 2
    v = [[-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0], [0, -1, t], [0, 1, t],
         [0, -1, -t], [0, 1, -t], [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]]
    f = [[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11], [1, 5, 9], [5, 11, 4],
         [11, 10, 2], [10, 7, 6], [7, 1, 8], [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8],
         [3, 8, 9], [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]]
    verts = [np.asarray(p, np.float64) / np.linalg.norm(p) for p in v]
    for _ in range(subdiv):
        mids, nf = {}, []

        def mid(a, b):
            key = (min(a, b), max(a, b))
            if key not in mids:
                m = verts[a] + verts[b]
                verts.append(m / np.linalg.norm(m))
                mids[key] = len(verts) - 1
            return mids[key]

        for a, b, c in f:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            nf += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        f = nf
    verts = np.asarray(verts) * (1 + jitter * np.random.default_rng(seed).normal(
        size=(len(verts), 1)))
    return verts, np.asarray(f, np.int64)


def cameras(eye=(1.2, 0.9, 3.5)):
    rot, pos = jd.lookat_camera(eye, (0, 0, 0), (0, 1, 0))
    proj = jd.perspective_proj_matrix(math.radians(40.0))
    rot_t, pos_t, proj_t = (x.astype(np.float64) for x in (rot, pos, proj))
    return ((jnp.asarray(rot_t)[None], jnp.asarray(pos_t)[None], jnp.asarray(proj_t)),
            (torch.from_numpy(rot_t)[None], torch.from_numpy(pos_t)[None],
             torch.from_numpy(proj_t)))


def mode_args(verts, seed=1):
    """Each mode's extra inputs, seeded: numpy arrays."""
    rng = np.random.default_rng(seed)
    P = len(verts)
    uv = rng.uniform(0, 1, (1, P, 2))
    tex = rng.uniform(0, 1, (1, 3, 8, 8))
    return {
        "VertexColor": [rng.uniform(0, 1, (1, P, 3))],
        "Lambertian": [uv, tex],
        "SphericalHarmonics": [uv, tex, rng.normal(size=(1, 9))],
        "Phong": [uv, tex, np.asarray([[0.3, 0.5, 0.8]]) / np.linalg.norm([0.3, 0.5, 0.8]),
                  rng.uniform(0.2, 0.8, (1, 3, 3)), np.asarray([[4.0]])],
    }


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


@pytest.mark.parametrize("mode,filtering", [("VertexColor", "nearest"),
                                            ("Lambertian", "nearest"),
                                            ("Lambertian", "bilinear"),
                                            ("SphericalHarmonics", "nearest"),
                                            ("Phong", "nearest")])
def test_modes_match_jax(mode, filtering):
    verts, faces = icosphere()
    cj, ct = cameras()
    args = mode_args(verts)[mode]
    out_j = jd.Renderer(40, 48, mode, filtering)(
        (jnp.asarray(verts)[None], faces), cj, *map(jnp.asarray, args))
    out_t = td.Renderer(40, 48, mode, filtering)(
        (torch.from_numpy(verts)[None], faces), ct, *map(torch.from_numpy, args))
    for name, a, b in zip(("color", "improb", "normal"), out_t, out_j):
        assert a.dtype == torch.float64 and a.shape == b.shape, name
        assert _rel(a.numpy(), b) <= BAR, (name, _rel(a.numpy(), b))
    improb = out_t[1].numpy()
    assert (improb == 1.0).any() and (improb < 0.5).any()  # covered and background


def _projected(verts, faces):
    cj, ct = cameras()
    pj = jd.perspective_projection(jnp.asarray(verts)[None], faces, cj)
    pt = td.perspective_projection(torch.from_numpy(verts)[None], faces, ct)
    return pj, pt


@pytest.mark.parametrize("knum,chunk,tile", [(30, 64, 32), (None, 64, 32), (3, 7, 8),
                                             (30, 64, None), (3, 7, None)])
def test_zbuffer_winner_equals_jax(knum, chunk, tile):
    """``tile`` None is the dense pass (every chunk at every pixel)."""
    verts, faces = icosphere(seed=3)
    (p3j, p2j, nj), (p3t, p2t, nt) = _projected(verts, faces)
    for a, b in zip((p3t, p2t, nt), (p3j, p2j, nj)):
        assert _rel(a.numpy(), b) <= BAR
    ids = np.broadcast_to(np.arange(len(faces), dtype=np.float64)[None, :, None, None],
                          (1, len(faces), 3, 1)).copy()
    ids = np.concatenate([ids, np.ones_like(ids)], axis=-1)  # [index, coverage]
    fj, ij = jd.linear_rasterize(32, 32, p3j, p2j, nj[..., 2:3], jnp.asarray(ids),
                                 face_chunk=chunk, knum=knum)
    ft, it = td.linear_rasterize(32, 32, p3t, p2t, nt[..., 2:3], torch.from_numpy(ids),
                                 face_chunk=chunk, knum=knum, tile=tile)
    covered = np.asarray(fj)[..., 1] > 0.5
    assert covered.sum() > 100
    np.testing.assert_array_equal(ft.numpy()[..., 1] > 0.5, covered)
    np.testing.assert_array_equal(np.rint(ft.numpy()[..., 0])[covered],
                                  np.rint(np.asarray(fj)[..., 0])[covered])
    assert _rel(ft.numpy(), fj) <= BAR and _rel(it.numpy(), ij) <= BAR


@pytest.mark.parametrize("mode", ["VertexColor", "SphericalHarmonics"])
def test_tiled_equals_dense(mode, monkeypatch):
    verts, faces = icosphere(subdiv=3, seed=6)
    _, ct = cameras()
    args = [torch.from_numpy(a) for a in mode_args(verts)[mode]]
    pts = (torch.from_numpy(verts)[None], faces)
    raster = td.linear_rasterize
    out = {}
    for tile in (None, 8, 32):
        monkeypatch.setattr(td, "linear_rasterize",
                            lambda *a, tile=tile, **k: raster(*a, **k, tile=tile))
        out[tile] = td.Renderer(56, 72, mode)(pts, ct, *args)
    for tile in (8, 32):
        for a, b in zip(out[tile], out[None]):
            assert _rel(a.numpy(), b.numpy()) <= 1e-12


def _row_scene(F=8):
    """tests/test_dibr.py's TestKnum scene: F small triangles in a row right
    of the centre, every face a candidate at every pixel under a large
    expand."""
    tris = [[[x, -0.05, 0.0], [x + 0.06, -0.05, 0.0], [x + 0.03, 0.05, 0.0]]
            for x in (0.1 + 0.08 * i for i in range(F))]
    p2 = np.asarray(tris, np.float64)[None][..., :2]
    p3 = np.concatenate([p2, np.ones((1, F, 3, 1))], axis=-1)
    return p3, p2, np.ones((1, F, 1)), np.ones((1, F, 3, 3))


def _both(p3, p2, nz, ft, **kw):
    _, a = td.linear_rasterize(16, 16, *map(torch.from_numpy, (p3, p2, nz, ft)), **kw)
    _, b = jd.linear_rasterize(16, 16, *map(jnp.asarray, (p3, p2, nz, ft)), **kw)
    assert _rel(a.numpy(), b) <= BAR
    return a.numpy()


def test_first_knum_candidates_in_face_order():
    F, k = 8, 3
    p3, p2, nz, ft = _row_scene(F)
    kw = dict(expand=4.0, face_chunk=2, sigmainv=5.0)
    improb_k = _both(p3, p2, nz, ft, knum=k, **kw)
    improb_trunc = _both(p3[:, :k], p2[:, :k], nz[:, :k], ft[:, :k], knum=None, **kw)
    probe = (0, 8, 0, 0)  # left edge, mid height: uncovered
    assert improb_k[probe] > 0.0
    np.testing.assert_allclose(improb_k[probe], improb_trunc[probe], rtol=1e-12)
    improb_all = _both(p3, p2, nz, ft, knum=None, **kw)
    assert improb_all[probe] > improb_k[probe]  # the cap binds


def test_knum_geq_faces_matches_dense():
    p3, p2, nz, ft = _row_scene(6)
    a = _both(p3, p2, nz, ft, knum=6, expand=4.0, face_chunk=4)
    b = _both(p3, p2, nz, ft, knum=None, expand=4.0, face_chunk=4)
    np.testing.assert_allclose(a, b, rtol=1e-12)


@pytest.mark.parametrize("mode", ["VertexColor", "Phong"])
def test_vertex_gradient_matches_jax_grad(mode):
    verts, faces = icosphere(subdiv=1, seed=4)
    cj, ct = cameras()
    args = mode_args(verts, seed=2)[mode]
    rng = np.random.default_rng(9)
    w_img, w_prob = rng.normal(size=(1, 24, 24, 3)), rng.normal(size=(1, 24, 24, 1))

    def loss_j(v):
        img, prob, _ = jd.Renderer(24, 24, mode)((v, faces), cj, *map(jnp.asarray, args))
        return jnp.sum(img * w_img) + jnp.sum(prob * w_prob)

    g_j = np.asarray(jax.grad(loss_j)(jnp.asarray(verts)[None]))
    v = torch.from_numpy(verts)[None].requires_grad_(True)
    img, prob, _ = td.Renderer(24, 24, mode)((v, faces), ct, *map(torch.from_numpy, args))
    (torch.sum(img * torch.from_numpy(w_img)) + torch.sum(prob * torch.from_numpy(w_prob))
     ).backward()
    assert np.abs(g_j).max() > 0
    assert _rel(v.grad.numpy(), g_j) <= GRAD_BAR


def test_camera_helpers_and_texture_sampling_match_jax():
    for eye in [(0, 0, 4.0), (1.5, -2.0, 0.5)]:
        for a, b in zip(td.lookat_camera(eye, (0.1, 0.2, 0.0), (0, 1, 0)),
                        jd.lookat_camera(eye, (0.1, 0.2, 0.0), (0, 1, 0))):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(td.perspective_proj_matrix(0.7, 1.3),
                                  jd.perspective_proj_matrix(0.7, 1.3))
    rng = np.random.default_rng(2)
    uv = rng.uniform(-1.5, 2.5, (2, 5, 7, 2))
    tex = rng.uniform(0, 1, (2, 3, 6, 9))
    for filtering in ("nearest", "bilinear"):
        a = td.tex_interpolation(torch.from_numpy(uv), torch.from_numpy(tex), filtering)
        b = jd.tex_interpolation(jnp.asarray(uv), jnp.asarray(tex), filtering)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-15)
    with pytest.raises(ValueError, match="unknown render mode"):
        td.Renderer(8, 8, mode="Toon")
