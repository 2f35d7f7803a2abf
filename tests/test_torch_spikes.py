"""The spike-pattern scene (tests/golden/rosensweig3d_spikes_ref.npz, the
reference solver's perturbed 64x33x64 Rosensweig pool with
``mag_flags_shell``) through the port on the CPU, and ``chip_smoke.py``'s
spike bars.

* The port's plain float32 step from the golden's initial fields (primed:
  the capillogue steady state with the scalar carry), 5 steps, against the
  JAX package's ``ferrofluid_step_impl`` (its runner, as
  tools/run_rosensweig_spikes_ours.py drives it) at phase 3's bars: rel
  5e-5 per field, velocities also at abs 5e-6; the scalar carry through
  ``compare_views`` against the JAX carry rebuilt as a channel h.
* Turbo (f, g, h in bfloat16), 3 steps: tests/test_torch_bf16_slice.py's
  bar, the port-vs-JAX distance on density, rho and vel at most a quarter
  of JAX's own bfloat16-vs-float32 distance.
* ``chip_smoke.spike_failures`` (the bars of tests/test_spike_parity.py
  that the card's 4000-step runs are held to) passes on the committed
  ``rosensweig3d_spikes_ours_{f32,turbo}.npz`` and fails on copies with
  one snapshot's pattern one wavenumber bin off.
"""

import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch


ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from lbm_ferrofluid_tpu import models as jm  # noqa: E402
from lbm_ferrofluid_tpu.ops import scalar_poisson as jsp  # noqa: E402
from lbm_ferrofluid_tpu_torch.ops.scalar_poisson import compare_views  # noqa: E402

GOLDEN = ROOT / "tests" / "golden"
FIELDS = ("f", "g", "rho", "vel", "density", "pressure")


@pytest.fixture(autouse=True)
def _one_thread():
    """One PyTorch thread: the tier-1 run puts six test processes on the
    machine's cores, and PyTorch's default pool would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref():
    return np.load(chip_smoke.SPIKE_REF)


def _jax_runs(ref, mode, marks):
    """JAX states after each step count in ``marks``."""
    jp = jm.SimulationParams.from_json(chip_smoke.spike_params(ref, mode).to_json())
    res = ref["flags"].shape[2:]
    js = jm.init_ferrofluid_state(jp, ref["rho0"].astype(np.float32),
                                  ref["den0"].astype(np.float32),
                                  np.zeros((1, 3, *res), np.float32), ref["flags"], ref["mflags"])
    runner = jm.SimulationRunner(jp, jm.ferrofluid_step_impl)
    out, done = {}, 0
    for n in marks:
        js = runner.run(js, n - done)
        done = n
        out[n] = js
    return out


def _dist(a, b):
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


def test_float32_steps_match_jax(ref):
    js = _jax_runs(ref, "float32", [5])[5]
    ps, _, _ = chip_smoke.spike_run(ref, "float32", "cpu", steps=5)
    assert ps.step == int(js.step) == 5 and ps.premac is not None
    for name in FIELDS:
        a, b = getattr(ps, name).double().numpy(), np.asarray(getattr(js, name), np.float64)
        err = np.abs(a - b).max()
        r = err / np.abs(b).max()
        assert r <= chip_smoke.BAR_REL or (name == "vel" and err <= chip_smoke.BAR_VEL_ABS), (
            name, r, err)
    assert ps.h.shape[1] == 2 and js.h.shape[1] == 2
    zero = jnp.zeros_like(js.h[:, :1])
    h_channel = jsp.h_from_scalar(js.h[:, :1], js.h[:, 1:2], zero, js.magnetic_flags, "float32")
    a, b = compare_views(ps.h, torch.from_numpy(np.array(h_channel)), ps.magnetic_flags)
    r = _dist(a, b) / float(b.abs().max())
    assert r <= chip_smoke.BAR_REL, r


def test_turbo_steps_track_jax(ref):
    j16 = _jax_runs(ref, "turbo", [3])[3]
    j32 = _jax_runs(ref, "float32", [3])[3]
    p16, _, _ = chip_smoke.spike_run(ref, "turbo", "cpu", steps=3)
    assert p16.f.dtype == torch.bfloat16 and p16.h.dtype == torch.float32
    for name in ("density", "rho", "vel"):
        port = getattr(p16, name).float().numpy()
        own = _dist(getattr(j16, name), getattr(j32, name))
        assert own > 0
        assert _dist(port, getattr(j16, name)) <= 0.25 * own, (name, own)


def _snaps(path):
    d = np.load(path)
    return {s: d[f"den_{s}"] for s in chip_smoke.SPIKE_SNAPS}


@pytest.mark.parametrize("mode,name", [("float32", "rosensweig3d_spikes_ours_f32.npz"),
                                       ("turbo", "rosensweig3d_spikes_ours_turbo.npz")])
def test_spike_bars_pass_on_committed_runs(ref, mode, name):
    rows, failed = chip_smoke.spike_failures(ref, _snaps(GOLDEN / name), mode)
    assert not failed, failed
    assert sorted(rows) == list(chip_smoke.SPIKE_SNAPS)
    if mode == "float32":
        assert (rows[2500]["k"], rows[3000]["k"]) == (4, 3)


@pytest.mark.parametrize("mode,name,step", [
    ("float32", "rosensweig3d_spikes_ours_f32.npz", 3000),
    ("float32", "rosensweig3d_spikes_ours_f32.npz", 1000),
    ("turbo", "rosensweig3d_spikes_ours_turbo.npz", 4000),
])
def test_spike_bars_fail_one_bin_off(ref, mode, name, step):
    """One snapshot replaced by a snapshot whose dominant wavenumber is one
    bin off (k 4 in place of 3, or 3 in place of 4)."""
    snaps = _snaps(GOLDEN / name)
    other = 2500 if step >= 3000 else 3000
    snaps[step] = snaps[other]
    rows, failed = chip_smoke.spike_failures(ref, snaps, mode)
    assert abs(rows[step]["k"] - rows[step]["k_ref"]) == 1
    assert any(f"step {step}: k" in f for f in failed), failed
