"""The port's artifact IO (``lbm_ferrofluid_tpu_torch/utils/io.py``) against
the JAX package's (``lbm_ferrofluid_tpu/utils/io.py``): PNG pixels bit for
bit (decoded with PIL), OBJ and Tecplot files byte for byte against the
JAX writers' numpy branch (both packages' native writers disabled), and the port's own
PNG reader and writer."""

import numpy as np
import pytest
import torch
from PIL import Image

from lbm_ferrofluid_tpu.utils import io as jio
from lbm_ferrofluid_tpu_torch.utils import io as tio


@pytest.fixture(autouse=True)
def _one_thread():
    """One PyTorch thread: the tier-1 run puts six test processes on the
    machine's cores, and PyTorch's default pool would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def numpy_writers(monkeypatch):
    """Both packages' Tecplot writers on their Python loops (the native
    writers print ``%g``)."""
    import lbm_ferrofluid_tpu.native as native
    import lbm_ferrofluid_tpu_torch.native as tnative

    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setattr(tnative, "available", lambda: False)


def _png(path):
    return np.asarray(Image.open(path))


FIELDS = {
    "2d ramp": np.linspace(0, 1, 64).reshape(1, 1, 8, 8),
    "2d f32": np.random.default_rng(0).normal(size=(2, 1, 9, 13)).astype(np.float32),
    "2d two channels": np.random.default_rng(1).normal(size=(1, 2, 7, 5)).astype(np.float32),
    "2d three channels": np.random.default_rng(2).uniform(size=(1, 3, 6, 6)),
    "3d f32": np.random.default_rng(3).uniform(size=(1, 1, 4, 8, 10)).astype(np.float32),
    "3d f64": np.random.default_rng(4).uniform(size=(1, 1, 5, 6, 7)),
    "constant": np.full((1, 1, 5, 5), 0.25, np.float32),
}


@pytest.mark.parametrize("name", sorted(FIELDS))
def test_save_img_pixels_equal_jax(tmp_path, name):
    field = FIELDS[name]
    jio.save_img(field, str(tmp_path / "j.png"))
    tio.save_img(torch.from_numpy(field), str(tmp_path / "t.png"))
    tio.save_img(field, str(tmp_path / "n.png"))
    a, b = _png(tmp_path / "t.png"), _png(tmp_path / "j.png")
    assert a.dtype == b.dtype == np.uint8 and a.shape == b.shape
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(_png(tmp_path / "n.png"), b)
    np.testing.assert_array_equal(tio.read_png(tmp_path / "t.png"), b)


def test_save_img_bfloat16_widens(tmp_path):
    field = torch.linspace(0, 1, 64).reshape(1, 1, 8, 8).to(torch.bfloat16)
    tio.save_img(field, str(tmp_path / "t.png"))
    jio.save_img(field.float().numpy(), str(tmp_path / "j.png"))
    np.testing.assert_array_equal(_png(tmp_path / "t.png"), _png(tmp_path / "j.png"))


def test_save_img_orientation(tmp_path):
    tio.save_img(torch.linspace(0, 1, 64).reshape(1, 1, 8, 8), str(tmp_path / "f.png"))
    img = tio.read_png(tmp_path / "f.png")
    assert img.shape == (8, 8, 3) and img.min() == 0 and img.max() == 255
    assert img[0].max() == 255 and img[-1].min() == 0  # y up
    with pytest.raises(ValueError):
        tio.save_img(torch.zeros(8, 8), str(tmp_path / "bad.png"))


def test_png_roundtrip(tmp_path):
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (23, 17, 3), dtype=np.uint8)
    tio.write_png(tmp_path / "a.png", img)
    np.testing.assert_array_equal(tio.read_png(tmp_path / "a.png"), img)
    np.testing.assert_array_equal(_png(tmp_path / "a.png"), img)
    # rows under PIL's filters, and a file that is no PNG, are refused
    smooth = (np.add.outer(np.arange(40), np.arange(30))[..., None] * np.array([1, 2, 3])
              % 256).astype(np.uint8)
    Image.fromarray(smooth).save(tmp_path / "b.png", optimize=True)
    with pytest.raises(ValueError, match="unfiltered"):
        tio.read_png(tmp_path / "b.png")
    (tmp_path / "c.png").write_bytes(b"not a png")
    with pytest.raises(ValueError, match="not a PNG"):
        tio.read_png(tmp_path / "c.png")


MESHES = {
    "zero based": (np.asarray([[0, 0, 0], [1, 0, 0], [0, 1, 0]]), np.asarray([[0, 1, 2]])),
    "float32": (np.random.default_rng(6).normal(size=(7, 3)).astype(np.float32),
                np.asarray([[0, 1, 2], [2, 3, 4], [4, 5, 6]])),
    "one based": (np.random.default_rng(7).uniform(size=(4, 3)), np.asarray([[1, 2, 3], [2, 3, 4]])),
    "empty": (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)),
}


@pytest.mark.parametrize("name", sorted(MESHES))
def test_export_obj_bytes_equal_jax(tmp_path, name):
    verts, faces = MESHES[name]
    jio.export_obj(str(tmp_path / "j.obj"), verts, faces)
    tio.export_obj(str(tmp_path / "t.obj"), torch.from_numpy(verts), torch.from_numpy(faces))
    tio.export_obj(str(tmp_path / "n.obj"), verts, faces)
    want = (tmp_path / "j.obj").read_bytes()
    assert (tmp_path / "t.obj").read_bytes() == want
    assert (tmp_path / "n.obj").read_bytes() == want
    if name == "zero based":
        assert "f 1 2 3" in want.decode()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_dump_2d_plt_bytes_equal_jax(tmp_path, numpy_writers, dtype):
    rng = np.random.default_rng(8)
    density = rng.uniform(size=(2, 1, 3, 4)).astype(dtype)
    uv = rng.uniform(size=(2, 2, 3, 4)).astype(dtype)
    for batch in (0, 1):
        jio.dump_2d_plt(str(tmp_path / "j.plt"), density, uv, batch)
        tio.dump_2d_plt(str(tmp_path / "t.plt"), torch.from_numpy(density),
                        torch.from_numpy(uv), batch)
        want = (tmp_path / "j.plt").read_bytes()
        assert (tmp_path / "t.plt").read_bytes() == want
    lines = want.decode().splitlines()
    assert lines[:4] == ['TITLE ="Magnetic internal force"', 'VARIABLES = "X" "Y" "RHO" "U" "V" ',
                         "ZONE I=4, J=3", "F=POINT"]
    assert len(lines) == 4 + 12


def test_dump_3d_plt_bytes_equal_jax(tmp_path, numpy_writers):
    D, H, W = 2, 3, 4
    rng = np.random.default_rng(9)
    density = rng.uniform(size=(1, 1, D, H, W)).astype(np.float32)
    u = rng.uniform(size=(1, 1, D, H, W + 1)).astype(np.float32)
    v = rng.uniform(size=(1, 1, D, H + 1, W)).astype(np.float32)
    w = rng.uniform(size=(1, 1, D + 1, H, W)).astype(np.float32)
    jio.dump_3d_plt(str(tmp_path / "j.plt"), density, u, v, w)
    tio.dump_3d_plt(str(tmp_path / "t.plt"), *map(torch.from_numpy, (density, u, v, w)))
    want = (tmp_path / "j.plt").read_bytes()
    assert (tmp_path / "t.plt").read_bytes() == want
    assert len(want.decode().splitlines()) == 4 + D * H * W


def test_mkdir(tmp_path):
    tio.mkdir(str(tmp_path / "a" / "b"))
    tio.mkdir(str(tmp_path / "a" / "b"))
    assert (tmp_path / "a" / "b").is_dir()
