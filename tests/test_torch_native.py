"""The port's native host library (``lbm_ferrofluid_tpu_torch/native/``):
built at first use with g++ from the port's own ``lbmnative.cpp``; its
marching tetrahedra against the port's numpy path and the JAX package's
numpy path with tests/test_native.py's rounding (and the triangle sets,
not only the vertices); its Tecplot files through tests/test_native.py's
checks and the port's writers; two processes building at once leave one
good library; a compiler that fails raises with its log."""

import multiprocessing
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from lbm_ferrofluid_tpu.render import mesh as jmesh
from lbm_ferrofluid_tpu_torch import native
from lbm_ferrofluid_tpu_torch.render import mesh as tmesh
from lbm_ferrofluid_tpu_torch.utils import io as tio

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _rounded_verts(v):
    """tests/test_native.py's comparison key: vertices rounded to 5
    decimals, sorted as records."""
    v = np.asarray(v, np.float32).round(5)
    return np.sort(v.view([("a", "f4"), ("b", "f4"), ("c", "f4")]).ravel())


def _rounded_tris(v, f):
    """The triangle set: each triangle's rounded corners, rotated to start
    at the smallest, in sorted order."""
    t = np.asarray(v, np.float64)[f].round(4)
    keys = []
    for tri in t:
        rows = [tuple(r) for r in tri]
        i = rows.index(min(rows))
        keys.append(tuple(rows[i:] + rows[:i]))
    return sorted(keys)


def _volumes():
    n, r = 24, 8.0
    c = (n - 1) / 2
    i, j, k = np.mgrid[0:n, 0:n, 0:n]
    rng = np.random.default_rng(3)
    return {
        "sphere": (np.sqrt((i - c) ** 2 + (j - c) ** 2 + (k - c) ** 2) - r).astype(np.float32),
        "noise": rng.normal(size=(9, 7, 11)).astype(np.float32),
        "empty": np.ones((5, 6, 7), np.float32),
    }


def test_builds_from_the_ports_source():
    assert native.available()
    lib = native.build()
    assert lib.parent == ROOT / "build" / "torch_native" and lib.exists()
    assert native.SOURCE == ROOT / "lbm_ferrofluid_tpu_torch" / "native" / "lbmnative.cpp"
    assert "lbm_ferrofluid_tpu/" not in str(lib)


@pytest.mark.parametrize("name", ["sphere", "noise", "empty"])
def test_marching_tetrahedra_equals_numpy_paths(name, monkeypatch):
    vol = _volumes()[name]
    v_cc, f_cc = native.marching_tetrahedra_native(vol, 0.0)
    assert v_cc.dtype == np.float32 and f_cc.dtype == np.int64
    # the dispatcher takes the native path
    np.testing.assert_array_equal(tmesh.marching_tetrahedra(vol, 0.0)[1], f_cc)
    v_np, f_np = tmesh.marching_tetrahedra_numpy(vol, 0.0)
    import lbm_ferrofluid_tpu.native as jnative

    monkeypatch.setattr(jnative, "available", lambda: False)
    v_j, f_j = jmesh.marching_tetrahedra(vol, 0.0)
    np.testing.assert_array_equal(v_np, v_j)
    np.testing.assert_array_equal(f_np, f_j)
    assert len(v_cc) == len(v_np) and len(f_cc) == len(f_np)
    np.testing.assert_array_equal(_rounded_verts(v_cc), _rounded_verts(v_np))
    assert _rounded_tris(v_cc, f_cc) == _rounded_tris(v_np, f_np)


def test_tecplot_2d(tmp_path):
    """tests/test_native.py's checks, and the port's writer takes the
    native path."""
    H, W = 4, 5
    rng = np.random.default_rng(0)
    d = rng.uniform(size=(1, 1, H, W)).astype(np.float32)
    uv = rng.uniform(size=(1, 2, H, W)).astype(np.float32)
    p = tmp_path / "out.plt"
    native.dump_2d_plt_native(str(p), d[0, 0], uv[0, 0], uv[0, 1])
    lines = p.read_text().splitlines()
    assert lines[0].startswith("TITLE")
    assert f"ZONE I={W}, J={H}" in lines[2]
    assert len(lines) == 4 + H * W
    x, y, rho, u, v = lines[4].split()
    assert abs(float(rho) - d[0, 0, 0, 0]) < 1e-5
    tio.dump_2d_plt(str(tmp_path / "io.plt"), d, uv)
    assert (tmp_path / "io.plt").read_bytes() == p.read_bytes()


def test_tecplot_3d_values(tmp_path):
    D, H, W = 3, 4, 5
    rng = np.random.default_rng(1)
    d = rng.uniform(size=(1, 1, D, H, W)).astype(np.float32)
    u = rng.uniform(size=(1, 1, D, H, W + 1)).astype(np.float32)
    v = rng.uniform(size=(1, 1, D, H + 1, W)).astype(np.float32)
    w = rng.uniform(size=(1, 1, D + 1, H, W)).astype(np.float32)
    p = tmp_path / "out.plt"
    tio.dump_3d_plt(str(p), d, u, v, w)
    lines = p.read_text().splitlines()
    assert f"ZONE I={W}, J={H}, K={D}" in lines[2] and len(lines) == 4 + D * H * W
    vals = np.asarray([[float(x) for x in line.split()] for line in lines[4:]])
    k, j, i = np.meshgrid(np.arange(D), np.arange(H), np.arange(W), indexing="ij")
    np.testing.assert_array_equal(vals[:, :3], np.stack([i, j, k], -1).reshape(-1, 3))
    uc = 0.5 * (u[..., 1:] + u[..., :-1])
    vc = 0.5 * (v[..., 1:, :] + v[..., :-1, :])
    wc = 0.5 * (w[..., 1:, :, :] + w[..., :-1, :, :])
    want = np.stack([a[0, 0].ravel() for a in (d, uc, vc, wc)], -1)
    np.testing.assert_allclose(vals[:, 3:], want, rtol=1e-5)


def _build_in_fresh_process(build_dir: str) -> str:
    code = (
        "import pathlib, sys\n"
        "from lbm_ferrofluid_tpu_torch import native\n"
        f"native.BUILD_DIR = pathlib.Path({build_dir!r})\n"
        "print(native.build())\n"
        "v, f = native.marching_tetrahedra_native(__import__('numpy').ones((3, 3, 3)) - 2)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout.strip()


def test_concurrent_builds_leave_one_good_library(tmp_path):
    with multiprocessing.get_context("spawn").Pool(2) as pool:
        paths = pool.map(_build_in_fresh_process, [str(tmp_path)] * 2)
    assert paths[0] == paths[1]
    libs = sorted(tmp_path.iterdir())
    assert [p.name for p in libs] == [pathlib.Path(paths[0]).name]  # no temporaries left
    code = ("import ctypes, sys; lib = ctypes.CDLL(sys.argv[1]); "
            "assert lib.mtetra_run and lib.dump_3d_plt")
    assert subprocess.run([sys.executable, "-c", code, paths[0]], timeout=60).returncode == 0


def test_failing_compiler_raises_with_its_log(tmp_path, monkeypatch):
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="failed on broken.cpp"):
        native.build()
    assert not any((tmp_path / "build").glob("*"))


def test_no_compiler_means_unavailable(monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_compiler", lambda: None)
    assert native.available() is False
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        native.build()
