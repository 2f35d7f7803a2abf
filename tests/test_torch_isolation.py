"""The port stands alone: no JAX, nothing of the JAX package, no silent CPU.

* ``lbm_ferrofluid_tpu_torch`` and every submodule import in a process where
  ``import jax`` and ``import ml_dtypes`` fail;
* no file of the package, nor ``chip_smoke.py``, imports ``jax``,
  ``lbm_ferrofluid_tpu`` or ``ml_dtypes`` (checked on the syntax tree; the
  card's machine has no ``ml_dtypes``, which comes here only with JAX),
  nor ``PIL`` or ``imageio`` at module level (the card's machine has
  neither);
* the modules that have a JAX twin of the same name (the compat facade,
  the DIB-R stack, the native library, the inverse-design driver) open,
  load and compile no file under ``lbm_ferrofluid_tpu/`` or the root
  ``native/`` (an audit hook on a run of each);
* without CUDA the entry points raise unless ``device="cpu"`` is passed,
  and a kernel wrapper given a tensor that is neither on the CPU nor on the
  card raises instead of running its plain version.
"""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "lbm_ferrofluid_tpu_torch"


def _py_files():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_package_imports_without_jax():
    code = (
        "import sys, importlib, pkgutil\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['lbm_ferrofluid_tpu'] = None\n"
        "sys.modules['ml_dtypes'] = None\n"
        "import lbm_ferrofluid_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "loaded = {k for k, v in sys.modules.items() if v is not None}\n"
        "assert 'jax' not in loaded and 'ml_dtypes' not in loaded\n"
        "print(len(names))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


@pytest.mark.parametrize("path", _py_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mods = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for m in mods:
            top = m.split(".")[0]
            assert top not in ("jax", "jaxlib", "lbm_ferrofluid_tpu", "ml_dtypes"), (
                f"{path.name}:{node.lineno} imports {m}"
            )


@pytest.mark.parametrize("path", _py_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_module_level_imaging_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in tree.body:
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mods = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for m in mods:
            assert m.split(".")[0] not in ("PIL", "imageio"), (
                f"{path.name}:{node.lineno} imports {m} at module level"
            )


_AUDITED_RUN = r"""
import contextlib, math, pathlib, sys, tempfile
seen = []
sys.addaudithook(lambda ev, args: seen.append((ev, repr(args)))
                 if ev in ("open", "ctypes.dlopen", "subprocess.Popen", "os.exec") else None)
import numpy as np, torch
from lbm_ferrofluid_tpu_torch import compat, native
from lbm_ferrofluid_tpu_torch.demo import demo_inverse_design
from lbm_ferrofluid_tpu_torch.render import dibr, load_textures, meshutils, voxelize
from lbm_ferrofluid_tpu_torch.utils import io
tmp = pathlib.Path(tempfile.mkdtemp())
native.BUILD_DIR = tmp / "native"  # a fresh build: the compiler's command line is seen
v, f = native.marching_tetrahedra_native(np.random.default_rng(0).normal(size=(5, 6, 7)))
io.dump_2d_plt(str(tmp / "a.plt"), np.ones((1, 1, 3, 4)), np.ones((1, 2, 3, 4)))
sp = compat.SimulationParameters(dim=3, simulation_size=(1, 1, 6, 8, 10), Q=19,
                                 device="cpu")
run = compat.SimulationRunner(sp)
coll, macro = run.create_collision_HCZ(), run.create_macro_compute()
rho = torch.full((1, 1, 6, 8, 10), 0.1); vel = torch.zeros((1, 3, 6, 8, 10))
fl = torch.ones((1, 1, 6, 8, 10), dtype=torch.uint8)
p = macro.get_pressure(1.0, 1.0, rho)
fe = coll.get_feq_(1.0, 1.0, rho, vel)
g = coll.get_geq_(1.0, 1.0, rho, rho, vel, p, feq=fe)
out = coll.capillary_process(rho, vel, fl, vel, g=g, density=rho, pressure=p)
coll.collision(1.0, 1.0, fe, out[0], out[1], out[2], fl, out[4], g=g, pressure=out[3],
               dfai=out[5], dprho=out[6])
pts = torch.tensor([[[1., 0, 0], [0, 1, 0], [0, 0, 1], [-1, -1, 0]]], dtype=torch.float64)
faces = np.asarray([[0, 1, 2], [0, 3, 1]])
rot, pos = dibr.lookat_camera((0, 0, 3.0), (0, 0, 0), (0, 1, 0))
cams = (torch.from_numpy(rot).double()[None], torch.from_numpy(pos).double()[None],
        torch.from_numpy(dibr.perspective_proj_matrix(math.radians(45))).double())
dibr.Renderer(8, 8)((pts, faces), cams, torch.ones((1, 4, 3), dtype=torch.float64))
voxelize(pts[:, faces] * 3 + 4, 8)
load_textures(torch.rand(4, 4, 3), torch.rand(2, 3, 2), 2)
meshutils.save_mesh(pts[0].numpy(), faces, str(tmp / "m.obj"))
meshutils.load_obj(str(tmp / "m.obj"))
with contextlib.suppress(SystemExit):
    demo_inverse_design.main(["--res", "8", "8", "--steps", "1", "--iters", "1",
                              "--device", "cpu", "--out_dir", str(tmp / "inv")])
root = pathlib.Path(sys.argv[1])
bad = [s for s in seen if str(root / "lbm_ferrofluid_tpu") + "/" in s[1]
       or str(root / "native") + "/" in s[1] or "build_native" in s[1]]
assert any(ev == "subprocess.Popen" and "lbmnative.cpp" in a for ev, a in seen), seen
print(len(seen), bad)
assert not bad, bad
"""


def test_new_modules_touch_nothing_of_the_jax_package():
    out = subprocess.run(
        [sys.executable, "-c", _AUDITED_RUN, str(ROOT)], cwd=ROOT, capture_output=True,
        text=True, timeout=300,
    )
    assert out.returncode == 0, out.stdout + out.stderr


def _cpu_state():
    from lbm_ferrofluid_tpu_torch.models import rosensweig_3d

    return rosensweig_3d(res=(6, 8, 10), device="cpu")


def _entry_points():
    from lbm_ferrofluid_tpu_torch.models import (
        SimulationRunner,
        droplet_spread_3d,
        ferrofluid_step,
        hcz_step,
        init_ferrofluid_state,
        init_hcz_state,
        multiphase_3d,
        prime_premac,
        rosensweig_3d,
        two_droplets_3d,
    )

    z = np.zeros((1, 1, 6, 8, 10), np.float32)
    v = np.zeros((1, 3, 6, 8, 10), np.float32)
    fl = z.astype(np.uint8) + 1

    def init(params, state):
        init_ferrofluid_state(params, z + 0.1, z + 0.1, v, fl, fl)

    def hcz(params, state):
        hcz_step(*multiphase_3d(res=(6, 8, 10), device="cpu"))

    return {
        "rosensweig_3d": lambda params, state: rosensweig_3d(res=(6, 8, 10)),
        "multiphase_3d": lambda params, state: multiphase_3d(res=(6, 8, 10)),
        "droplet_spread_3d": lambda params, state: droplet_spread_3d(res=(6, 8, 10)),
        "two_droplets_3d": lambda params, state: two_droplets_3d(res=(6, 8, 10)),
        "init_ferrofluid_state": init,
        "init_hcz_state": lambda params, state: init_hcz_state(params, z + 0.1, z + 0.1, v,
                                                               fl),
        "prime_premac": lambda params, state: prime_premac(params, state),
        "ferrofluid_step": lambda params, state: ferrofluid_step(params, state),
        "ferrofluid_step (capillogue steady state)": lambda params, state: ferrofluid_step(
            params, prime_premac(params, state, device="cpu")),
        "ferrofluid_step (epilogue steady state)": lambda params, state: ferrofluid_step(
            params, state.replace(premac=prime_premac(params, state, device="cpu").premac[:5])),
        "hcz_step": hcz,
        "SimulationRunner": lambda params, state: SimulationRunner(params, ferrofluid_step),
        "SoftRenderer": lambda params, state: _render().SoftRenderer(image_size=8),
        "default_renderer": lambda params, state: _render().default_renderer(8),
        "make_render_pipeline": lambda params, state: _render().make_render_pipeline((6, 8, 10)),
        "run_demo": lambda params, state: _driver().run_demo(
            "x", params, state, ferrofluid_step, 1, 1, lambda s, f: None, _UNWRITTEN),
        **{f"demo {name}.main": _demo_main(name) for name in DEMO_NAMES},
        "compat.SimulationParameters": lambda params, state: _compat().SimulationParameters(
            dim=3, simulation_size=(1, 1, 6, 8, 10)),
        "compat.SimulationRunner": lambda params, state: _compat().SimulationRunner(
            _compat().SimulationParameters(dim=2)),
    }


#: an artifact directory the entry points must raise before creating
_UNWRITTEN = str(ROOT / "build" / "no_artifacts_without_cuda")


def _render():
    from lbm_ferrofluid_tpu_torch import render

    return render


def _driver():
    from lbm_ferrofluid_tpu_torch.demo import _driver

    return _driver


def _compat():
    from lbm_ferrofluid_tpu_torch import compat

    return compat


DEMO_NAMES = sorted(p.stem for p in (PKG / "demo").glob("demo_*.py"))


def _demo_main(name):
    def run(params, state):
        import importlib

        mod = importlib.import_module(f"lbm_ferrofluid_tpu_torch.demo.{name}")
        steps = ["--iters", "1"] if name == "demo_inverse_design" else ["--total_steps", "1"]
        mod.main([*steps, "--out_dir", _UNWRITTEN])

    return run


def test_every_demo_is_listed():
    assert len(DEMO_NAMES) == 13


@pytest.mark.parametrize("name", sorted(_entry_points()))
def test_entry_points_raise_without_cuda(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    params, state = _cpu_state()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _entry_points()[name](params, state)
    assert not pathlib.Path(_UNWRITTEN).exists()


def test_wrappers_refuse_non_cpu_non_cuda_tensors():
    from lbm_ferrofluid_tpu_torch.ops import kernels

    z = torch.zeros((1, 1, 6, 8, 10), device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.contact_angle_3d(z, z.to(torch.uint8), 1.0)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.scalar_wavefront(
            torch.zeros((1, 2, 6, 8, 10), device="meta"), z, z,
            n_iters=2, h_ext=(0.0, 1.0, 0.0),
        )
    f = torch.zeros((1, 19, 6, 8, 10), device="meta")
    v = torch.zeros((1, 3, 6, 8, 10), device="meta")
    fl = z.to(torch.uint8)
    gas = dict(rho_gas=0.1, rho_fluid=0.2, density_gas=0.1, density_fluid=0.2)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.stream_bounce_moments(f, fl)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.stream_bounce_macro(f, fl, z, v, c=1.0, **gas)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.hcz_capillary_gradmac(z, z, z, z, None, None, fl, z, v, v, kappa=0.1,
                                      gravity=(0.0, 0.0, 0.0), **gas)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.hcz_collide_fused(f, f, z, v, z, z, fl, v, v, v, tau_f=0.7, tau_g=0.7)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.poisson_sweeps(f, fl, z, tau=0.8, n_iters=2)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.grad_fields(v, dx=1.0)
    for emit in (False, True):
        with pytest.raises(ValueError, match="CUDA tensor"):
            kernels.lbm_epilogue(f, f, fl, z, v, z, z, v, v, v, tau_f=0.7, tau_g=0.7,
                                 emit_mac=emit, mac_consts=(1.0, 0.1, 0.2, 0.1, 0.2))
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.laplacian_field(z, dx=1.0)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.hcz_capillary_stencils(z, v, fl, z, z, z, g=f, kappa=0.1,
                                       gravity=torch.zeros(1, 3, 1, 1, 1, device="meta"),
                                       **gas)
    assert all(v == 0 for v in kernels.launch_counts().values())
