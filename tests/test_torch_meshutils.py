"""The port's copy of the DIB-R mesh utilities
(``lbm_ferrofluid_tpu_torch/render/meshutils.py``) against the JAX
package's (``lbm_ferrofluid_tpu/render/meshutils.py``): every function's
outputs bit for bit on seeded inputs, and the OBJ files (plain, vertex
color, textured with its MTL) byte for byte."""

import numpy as np
import pytest

from lbm_ferrofluid_tpu.render import meshutils as jm
from lbm_ferrofluid_tpu_torch.render import meshutils as tm
from lbm_ferrofluid_tpu_torch.utils.io import read_png


def _mesh():
    """A closed octahedron, subdivided once."""
    v = np.asarray([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]],
                   np.float32)
    f = np.asarray([[0, 2, 4], [2, 1, 4], [1, 3, 4], [3, 0, 4], [2, 0, 5], [1, 2, 5],
                    [3, 1, 5], [0, 3, 5]])
    return jm.mesh_resample(v, f)


def _equal(a, b):
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
        return
    if a is None:
        assert b is None
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def test_every_function_is_ported():
    assert tm.__all__ == jm.__all__


@pytest.mark.parametrize("name,args", [
    ("face2edge", lambda v, f: (f,)),
    ("face2edge2", lambda v, f: (f, jm.face2edge(f))),
    ("edge2face", lambda v, f: (f, jm.face2edge(f))),
    ("face2pfmtx", lambda v, f: (f,)),
    ("face2pneimtx", lambda v, f: (f,)),
    ("mesh_resample", lambda v, f: (v, f)),
    ("rotx", lambda v, f: (0.7,)),
    ("roty", lambda v, f: (35.0, "deg")),
    ("rotz", lambda v, f: (-1.3,)),
    ("homogenize_points", lambda v, f: (v,)),
    ("unhomogenize_points", lambda v, f: (np.concatenate([v, v[:, :1] - 0.5], 1),)),
    ("transform3d", lambda v, f: (v, _tform())),
    ("invert_rigid_transform_3d", lambda v, f: (_tform(),)),
    ("compose_transforms_3d", lambda v, f: ([_tform(), np.eye(4), _tform(2)],)),
    ("compute_camera_params", lambda v, f: (30.0, 20.0, 2.5)),
    ("get_spherical_coords_x", lambda v, f: (v + 0.1,)),
    ("get_spherical_coords_z", lambda v, f: (v - 0.2,)),
])
def test_outputs_bit_for_bit(name, args):
    v, f = _mesh()
    a = args(v, f)
    _equal(getattr(tm, name)(*a), getattr(jm, name)(*a))


def _tform(seed=1):
    rng = np.random.default_rng(seed)
    t = np.eye(4)
    t[:3, :3] = jm.rotz(rng.uniform(-3, 3)) @ jm.rotx(rng.uniform(-3, 3))
    t[:3, 3] = rng.normal(size=3)
    return t


def test_obj_bytes_equal(tmp_path):
    v, f = _mesh()
    colors = np.random.default_rng(3).uniform(size=v.shape).astype(np.float32)
    uvs = np.random.default_rng(4).uniform(size=(len(v), 2)).astype(np.float32)
    for pkg, d in ((tm, tmp_path / "t"), (jm, tmp_path / "j")):
        d.mkdir()
        pkg.save_mesh(v, f, str(d / "m.obj"))
        pkg.save_mesh_color(v, f, str(d / "c.obj"), colors)
        pkg.save_mesh_color(v, f, str(d / "g.obj"))
        pkg.save_mesh_tex(v, uvs, f, str(d / "t.obj"))
    for name in ("m.obj", "c.obj", "g.obj", "t.obj", "t.mtl"):
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()
    _equal(tm.load_obj(str(tmp_path / "t" / "m.obj")), jm.load_obj(str(tmp_path / "j" / "m.obj")))
    _equal(tm.load_obj_tex(str(tmp_path / "t" / "t.obj")),
           jm.load_obj_tex(str(tmp_path / "j" / "t.obj")))


def test_textured_obj_png_without_pil(tmp_path):
    v, f = _mesh()
    img = np.random.default_rng(5).uniform(-0.2, 1.2, (6, 7, 3))
    tm.save_mesh_tex(v, np.zeros((len(v), 2)), f, str(tmp_path / "t.obj"), img)
    assert "map_Kd t.png" in (tmp_path / "t.mtl").read_text()
    np.testing.assert_array_equal(read_png(tmp_path / "t.png"),
                                  (np.clip(img, 0, 1) * 255).astype(np.uint8))
