"""The port stands alone: no JAX, nothing of the JAX package, no silent CPU.

* ``lbm_ferrofluid_tpu_torch`` and every submodule import in a process where
  ``import jax`` fails;
* no file of the package, nor ``chip_smoke.py``, imports ``jax`` or
  ``lbm_ferrofluid_tpu`` (checked on the syntax tree);
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
        "import lbm_ferrofluid_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "assert 'jax' not in {k for k, v in sys.modules.items() if v is not None}\n"
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
            assert top not in ("jax", "jaxlib", "lbm_ferrofluid_tpu"), (
                f"{path.name}:{node.lineno} imports {m}"
            )


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
        "hcz_step": hcz,
        "SimulationRunner": lambda params, state: SimulationRunner(params, ferrofluid_step),
    }


@pytest.mark.parametrize("name", sorted(_entry_points()))
def test_entry_points_raise_without_cuda(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    params, state = _cpu_state()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _entry_points()[name](params, state)


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
    assert all(v == 0 for v in kernels.launch_counts().values())
