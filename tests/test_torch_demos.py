"""The port's demo drivers (``lbm_ferrofluid_tpu_torch/demo/``) against the
JAX package's (``demo/``), on the CPU at tiny grids into ``tmp_path``.

Each driver runs a few steps with a frame every other step.  Its first
frame equals the JAX driver's first frame for the same scene and grid (the
JAX driver's own frame function on the JAX scene): density and vorticity
frames bit for bit; the 3D Rosensweig driver's rendered frame within one
gray level of the JAX renderer's image of the same phi.  Its last state
equals the JAX run (the JAX runner over the JAX step, as the JAX driver
runs it) at phase 3's bars: rel 5e-5 per field, velocities also at abs
5e-6.  KBC on g (``wave``) is held to the JAX package's eager
``hcz_step_impl``, which the port equals (ROADMAP §C).

The 3D Rosensweig driver renders phi derived from the density, as the
reference driver does (demo_3d_LBM_Rosensweig_instability.py:171); the
JAX driver renders ``phi_field``, the initial state's stored phi of zeros,
so its own first frame is blank.  Its first frame is therefore held to the
JAX renderer's image of the density-derived phi, with the mesh's
zero-area faces left out (see tests/test_torch_render.py:jax_frame).
"""

import dataclasses
import importlib
import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from lbm_ferrofluid_tpu import models as jm
from lbm_ferrofluid_tpu import render as jr
from lbm_ferrofluid_tpu.models import scenes as jscenes
from lbm_ferrofluid_tpu_torch.models import scenes as tscenes
from lbm_ferrofluid_tpu_torch.utils.io import read_png


@pytest.fixture(autouse=True)
def _one_thread():
    """One PyTorch thread: the tier-1 run puts six test processes on the
    machine's cores, and PyTorch's default pool would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROOT = pathlib.Path(__file__).resolve().parents[1]
RES2, RES3 = (16, 16), (12, 10, 12)
STEPS = 3


def _jax_demo(name):
    """A JAX demo module (its frame functions; its ``__main__`` block does
    not run on import)."""
    sys.path.insert(0, str(ROOT / "demo"))
    try:
        return importlib.import_module(name)
    finally:
        sys.path.remove(str(ROOT / "demo"))


def _jax_frame_fn(name):
    driver = _jax_demo("_driver")
    if name in ("demo_2d_LBM", "demo_2d_LBM_KBC"):
        return _jax_demo(name).vort_frame
    if name == "demo_2d_LBM_two_droplets":
        return _jax_demo(name).frame_with_plt
    interior = name in ("demo_2d_LBM_multiphase_HCZ", "demo_2d_LBM_multiphase_SC") or (
        name.startswith("demo_3d"))
    return driver.density_interior_frame if interior else driver.density_frame


#: driver -> (grid, JAX scene builder and its keywords, JAX step)
DEMOS = {
    "demo_2d_LBM": (RES2, "shear_layer", {"kbc": False}, "singlephase_step_impl"),
    "demo_2d_LBM_KBC": (RES2, "shear_layer", {"kbc": True}, "singlephase_step_impl"),
    "demo_2d_LBM_Rosensweig_instability": (
        RES2, "rosensweig_2d", {"mag_strength": 100.0, "gravity": 1e-4}, "ferrofluid_step_impl"),
    "demo_2d_LBM_droplet_spread": (RES2, "droplet_spread_2d", {"gravity": 1e-5},
                                   "hcz_step_impl"),
    "demo_2d_LBM_multiphase_HCZ": (RES2, "multiphase_drop_hcz", {}, "hcz_step_impl"),
    "demo_2d_LBM_multiphase_SC": (RES2, "multiphase_drop_sc", {}, "sc_step_impl"),
    "demo_2d_LBM_two_droplets": ((16, 32), "two_droplets_2d",
                                 {"mag_strength": 100.0, "gravity": 0.0}, "ferrofluid_step_impl"),
    "demo_2d_wave": (RES2, "wave", {}, "hcz_step_impl"),
    "demo_3d_LBM_droplet_spread": ((12, 12, 12), "droplet_spread_3d", {"gravity": 1e-5},
                                   "hcz_step_impl"),
    "demo_3d_LBM_multiphase": ((12, 12, 12), "multiphase_3d", {}, "hcz_step_impl"),
    "demo_3d_LBM_two_droplets": ((12, 12, 16), "two_droplets_3d",
                                 {"mag_strength": 100.0, "gravity": 0.0}, "ferrofluid_step_impl"),
}
FIELDS = ("f", "g", "rho", "vel", "density", "pressure")


def _run_port(name, res, tmp_path, *extra):
    mod = importlib.import_module(f"lbm_ferrofluid_tpu_torch.demo.{name}")
    out = tmp_path / "port"
    state = mod.main(["--res", *map(str, res), "--total_steps", str(STEPS), "--io_interval", "2",
                      "--device", "cpu", "--out_dir", str(out), *extra])
    frames = sorted(p.name for p in out.glob("*.png"))
    assert frames == ["00000.png", "00002.png", f"{STEPS:05d}.png"], frames
    return state, out


def _assert_state_close(port, jax_state):
    assert port.step == int(jax_state.step) == STEPS
    for name in FIELDS:
        b = getattr(jax_state, name, None)
        if b is None:
            continue
        a = getattr(port, name).double().numpy()
        b = np.asarray(b, np.float64)
        err = float(np.abs(a - b).max())
        r = err / max(float(np.abs(b).max()), 1e-30)
        assert r <= 5e-5 or (name == "vel" and err <= 5e-6), (name, r, err)


@pytest.mark.parametrize("name", sorted(DEMOS))
def test_demo_matches_jax(tmp_path, name):
    res, scene, kw, step = DEMOS[name]
    state, out = _run_port(name, res, tmp_path)
    jp, js = getattr(jscenes, scene)(res, **kw)
    _jax_frame_fn(name)(js, str(tmp_path / "jax0.png"))
    want = np.asarray(Image.open(tmp_path / "jax0.png"))
    np.testing.assert_array_equal(read_png(out / "00000.png"), want)
    if name == "demo_2d_wave":
        for _ in range(STEPS):
            js = jm.hcz_step_impl(jp, js)
    else:
        js = jm.SimulationRunner(jp, getattr(jm, step)).run(js, STEPS)
    _assert_state_close(state, js)


def test_rosensweig_demo_matches_jax(tmp_path, monkeypatch):
    import lbm_ferrofluid_tpu.native as native
    import lbm_ferrofluid_tpu_torch.native as tnative

    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setattr(tnative, "available", lambda: False)
    mod = importlib.import_module("lbm_ferrofluid_tpu_torch.demo.demo_3d_LBM_Rosensweig_instability")
    state, out = _run_port("demo_3d_LBM_Rosensweig_instability", RES3, tmp_path,
                           "--image_size", "16")
    jp, js = jscenes.rosensweig_3d(RES3, mag_strength=100.0, gravity=1e-4)
    phi = -(2.0 * (np.asarray(js.density) - jp.density_gas)
            / (jp.density_fluid - jp.density_gas) - 1.0)
    verts, faces = jr.phi_to_mesh(phi, RES3)
    tri = verts[faces]
    keep = np.linalg.norm(np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]), axis=1) > 0
    vb, fb = jr._bucket_mesh(verts, faces[keep])
    img = jr.default_renderer(16).forward(jnp.asarray(vb)[None], jnp.asarray(fb)[None],
                                          jnp.full((1, fb.shape[0], 2, 3), 0.68, jnp.float32))
    want = (np.clip(np.asarray(img[0, :3]).transpose(1, 2, 0), 0, 1) * 255).astype(np.uint8)
    got = read_png(out / "00000.png")
    assert got.shape == want.shape == (16, 16, 3)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    assert int(got.min()) < 250  # the pool is in the frame
    # the OBJ holds the final interface's host mesh
    phi_end = -(2.0 * (state.density.numpy() - jp.density_gas)
                / (jp.density_fluid - jp.density_gas) - 1.0)
    _, f_end = jr.phi_to_mesh(phi_end.astype(np.float32), RES3)
    obj = (out / mod.OBJ_NAME).read_text().splitlines()
    assert sum(line.startswith("f ") for line in obj) == len(f_end) > 0
    js = jm.SimulationRunner(jp, jm.ferrofluid_step_impl).run(js, STEPS)
    _assert_state_close(state, js)


def test_two_droplets_plt_at_step_400(tmp_path, monkeypatch):
    """The 2D two-droplets frame function dumps Tecplot at step 400, byte
    for byte as the JAX driver's (its numpy writer)."""
    import lbm_ferrofluid_tpu.native as native
    import lbm_ferrofluid_tpu_torch.native as tnative

    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setattr(tnative, "available", lambda: False)
    from lbm_ferrofluid_tpu_torch.demo import demo_2d_LBM_two_droplets as port

    jp, js = jscenes.two_droplets_2d((16, 32))
    tp, ts = tscenes.two_droplets_2d((16, 32), device="cpu")
    for step in (399, 400):
        port.frame_with_plt(ts.replace(step=step), str(tmp_path / f"p{step}.png"))
        _jax_frame_fn("demo_2d_LBM_two_droplets")(dataclasses.replace(js, step=step),
                                                  str(tmp_path / f"j{step}.png"))
    assert not (tmp_path / "p399.plt").exists()
    assert (tmp_path / "p400.plt").read_bytes() == (tmp_path / "j400.plt").read_bytes()


def test_tpu_layout_and_phys_view_name_a8(tmp_path):
    """``--tpu_layout 1`` (the padded transposed layout, ROADMAP A8) runs 2
    steps on the CPU at a small grid and writes its frames and OBJ through
    ``phys_view``: the final state is the padded one, and its physical
    view is the box; the plain layout's view is the field itself."""
    from lbm_ferrofluid_tpu_torch.demo import demo_3d_LBM_Rosensweig_instability as demo

    state = demo.main(["--tpu_layout", "1", "--device", "cpu", "--res", *map(str, RES3),
                       "--total_steps", "2", "--io_interval", "2", "--image_size", "32",
                       "--out_dir", str(tmp_path)])
    params, _ = tscenes.rosensweig_3d_tpu(RES3, device="cpu")
    assert tuple(state.density.shape[2:]) == (10, 16, 128) and int(state.step) == 2
    assert tscenes.phys_view(params, state.density).shape == (1, 1, *RES3)
    frames = sorted(p.name for p in (tmp_path).glob("*.png"))
    assert frames == ["00000.png", "00002.png"]
    assert (tmp_path / demo.OBJ_NAME).stat().st_size > 0
    params, state = tscenes.rosensweig_3d(RES3, device="cpu")
    assert tscenes.phys_view(params, state.density) is state.density
