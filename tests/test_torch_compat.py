"""The port's reference-style facade (``lbm_ferrofluid_tpu_torch/compat.py``)
against the JAX package's (``lbm_ferrofluid_tpu/compat.py``): the same
driver loop, op by op, on the same seeded numpy inputs, on the CPU.

* the two cases of tests/test_compat.py: 2D single phase for 10 steps
  (rtol 1e-4, atol 1e-6; also with the KBC and Shan-Chen collisions) and
  2D HCZ with KBC_A for 8 steps (rtol 1e-5, atol 1e-7), in float32;
* the 3D HCZ loop, and the 3D loop with ``get_H_int`` and the Kelvin
  term, at 16^3 in float64: every field within 1e-10 of the JAX facade's
  (max|a-b| / max|b|);
* ``device=None`` without CUDA raises; the frame counter; the 3D factories
  that return None.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lbm_ferrofluid_tpu import compat as jcompat  # noqa: E402

from lbm_ferrofluid_tpu_torch import compat as tcompat  # noqa: E402
from lbm_ferrofluid_tpu_torch.ops import kernels  # noqa: E402

OBS, FLUID = 2, 1
HCZ_GAS = dict(density_gas=0.02381, density_fluid=0.2508, rho_gas=0.02381, rho_fluid=0.2508)


@pytest.fixture(autouse=True)
def _one_thread():
    """One PyTorch thread: the tier-1 run puts six test processes on the
    machine's cores, and PyTorch's default pool would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Jax:
    mod = jcompat
    kw = {}

    @staticmethod
    def arr(a):
        return jnp.asarray(a)


class _Torch:
    mod = tcompat
    kw = {"device": "cpu"}

    @staticmethod
    def arr(a):
        return torch.from_numpy(np.array(a))


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _close_rel(name, got, want, bar):
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    assert np.isfinite(got).all(), name
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)
    assert err <= bar, f"{name}: rel {err:.3e} over {bar:.0e}"


def _single_phase(be, kind, res, vel0, n_steps=10, tau=0.9):
    sp = be.mod.SimulationParameters(dim=2, simulation_size=(1, 1, *res), tau=tau,
                                      density_gas=0.1, density_fluid=0.3, **be.kw)
    runner = be.mod.SimulationRunner(parameters=sp)
    prop, macro = runner.create_propagation(), runner.create_macro_compute()
    coll = {"bgk": runner.create_collision, "kbc": runner.create_collision_MRT,
            "sc": runner.create_collision_SC}[kind]()
    flags = be.arr(np.full((1, 1, *res), FLUID, np.uint8))
    density = be.arr(np.full((1, 1, *res), 0.265, np.float32))
    vel = be.arr(vel0)
    force = be.arr(np.zeros((1, 2, *res), np.float32))
    f = coll.get_feq_(dx=1.0, dt=1.0, rho=density, vel=vel, force=force)
    for _ in range(n_steps):
        f = prop.propagation(f=f)
        density, vel = macro.macro_compute(dx=1.0, dt=1.0, f=f, rho=density, vel=vel,
                                           flags=flags)
        f = prop.rebounce_obstacle(f=f, flags=flags)
        if kind == "sc":
            f = coll.collision(dx=1.0, dt=1.0, f=f, rho=density, density=density, vel=vel,
                               flags=flags, force=force)
        else:
            f = coll.collision(dx=1.0, dt=1.0, f=f, rho=density, vel=vel, flags=flags,
                               force=force, KBC_type=1 if kind == "kbc" else None)
        runner.step()
    assert runner.parameters.frame == n_steps
    return f, vel


@pytest.mark.parametrize("kind", ["bgk", "kbc", "sc"])
def test_single_phase_2d_matches_jax_facade(kind):
    res = (24, 20)
    vel0 = np.random.default_rng(0).uniform(-0.05, 0.05, (1, 2, *res)).astype(np.float32)
    f_t, vel_t = _single_phase(_Torch, kind, res, vel0)
    f_j, vel_j = _single_phase(_Jax, kind, res, vel0)
    np.testing.assert_allclose(_np(f_t), _np(f_j), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(_np(vel_t), _np(vel_j), rtol=1e-3, atol=1e-6)


def _hcz_scene(res, dtype, seed=0):
    """A fluid block in gas inside an obstacle ring, with seeded noise."""
    rng = np.random.default_rng(seed)
    flags = np.full((1, 1, *res), FLUID, np.uint8)
    for ax in range(len(res)):
        idx = [slice(None)] * 2 + [slice(None)] * len(res)
        for end in (0, -1):
            idx[2 + ax] = end
            flags[tuple(idx)] = OBS
    block = (Ellipsis,) + tuple(slice(n // 4 + 1, n - n // 4) for n in res)
    rho = np.full((1, 1, *res), HCZ_GAS["rho_gas"])
    den = np.full((1, 1, *res), HCZ_GAS["density_gas"])
    rho[block] = HCZ_GAS["rho_fluid"]
    den[block] = HCZ_GAS["density_fluid"]
    rho = rho * (1 + 1e-3 * rng.normal(size=rho.shape))
    vel = 1e-3 * rng.normal(size=(1, len(res), *res))
    return flags, rho.astype(dtype), den.astype(dtype), vel.astype(dtype)


def _hcz_loop(be, res, n_steps, dtype, kbc=None, magnetic=False):
    """The reference-style HCZ loop (tests/test_compat.py's order); with
    ``magnetic`` a Poisson sweep a step gives the Kelvin term."""
    dim = len(res)
    sp = be.mod.SimulationParameters(
        dim=dim, simulation_size=(1, 1, *res), kappa=0.1, tau_f=0.7, tau_g=0.8, tau=1.0,
        contact_angle=0.75 * math.pi, Q=9 if dim == 2 else 19, **HCZ_GAS, **be.kw)
    runner = be.mod.SimulationRunner(parameters=sp)
    prop, macro = runner.create_propagation(), runner.create_macro_compute()
    coll = runner.create_collision_HCZ()
    coll.preset_KBC(dx=1.0, dt=1.0)
    coll.set_gravity(gravity=1e-4)
    flags0, rho0, den0, vel0 = _hcz_scene(res, dtype)
    flags, rho, den, vel = map(be.arr, (flags0, rho0, den0, vel0))
    force = be.arr(np.zeros_like(vel0))
    pressure = macro.get_pressure(dx=1.0, dt=1.0, density=den)
    f = coll.get_feq_(dx=1.0, dt=1.0, rho=den, vel=vel, force=force)
    g = coll.get_geq_(dx=1.0, dt=1.0, rho=rho, vel=vel, density=den, pressure=pressure,
                      force=force, feq=f)
    if magnetic:
        mag = runner.create_LBM_magnetic()
        rng = np.random.default_rng(5)
        h = be.arr((1e-3 * rng.normal(size=(1, 19, *res))).astype(dtype))
        # the staggered external field, x first: X + 1 cells along x, and so on
        h_ext = [be.arr((1.0 + 0.01 * rng.normal(
            size=(1, 1, *(n + (a == ax) for a, n in enumerate(res))))).astype(dtype))
            for ax in reversed(range(dim))]
    out = {}
    for _ in range(n_steps):
        f = prop.propagation(f=f)
        g = prop.propagation(f=g)
        rho, vel, den = macro.macro_compute(dx=1.0, dt=1.0, f=f, rho=rho, vel=vel,
                                            flags=flags, density=den)
        f = prop.rebounce_obstacle(f=f, flags=flags)
        g = prop.rebounce_obstacle(f=g, flags=flags)
        kelvin = {}
        if magnetic:
            phi = 2.0 * (den - HCZ_GAS["density_gas"]) / (
                HCZ_GAS["density_fluid"] - HCZ_GAS["density_gas"]) - 1.0
            H_int, h = mag.get_H_int(dt=1.0, dx=1.0, phi=phi, flags=flags, H_ext_mac=h_ext,
                                     h=h)
            # a static field of 300 along y makes the Kelvin force count
            H2 = H_int[:, 0:1] ** 2 + (H_int[:, 1:2] + 300.0) ** 2 + H_int[:, 2:3] ** 2
            kelvin = dict(H2=H2, phi=phi)
            out["H_int"], out["h"] = H_int, h
        rho, vel, den, pressure, force, dfai, dprho = coll.capillary_process(
            rho=rho, vel=vel, flags=flags, force=force, dt=1.0, dx=1.0, g=g, density=den,
            pressure=pressure, **kelvin)
        f, g = coll.collision(dx=1.0, dt=1.0, f=f, rho=rho, vel=vel, density=den,
                              flags=flags, force=force, g=g, pressure=pressure, dfai=dfai,
                              dprho=dprho, KBC_type=kbc)
        runner.step()
    out.update(f=f, g=g, rho=rho, vel=vel, density=den, pressure=pressure, force=force,
               dfai=dfai, dprho=dprho)
    return out


def test_hcz_2d_kbc_matches_jax_facade():
    res = (20, 16)
    t = _hcz_loop(_Torch, res, 8, np.float32, kbc=1)
    j = _hcz_loop(_Jax, res, 8, np.float32, kbc=1)
    for name in ("f", "g", "density"):
        np.testing.assert_allclose(_np(t[name]), _np(j[name]), rtol=1e-5, atol=1e-7,
                                   err_msg=name)


@pytest.mark.parametrize("magnetic", [False, True], ids=["hcz", "kelvin"])
def test_hcz_3d_float64_matches_jax_facade(magnetic):
    res = (16, 16, 16)
    t = _hcz_loop(_Torch, res, 3, np.float64, magnetic=magnetic)
    j = _hcz_loop(_Jax, res, 3, np.float64, magnetic=magnetic)
    assert t.keys() == j.keys()
    for name in t:
        assert t[name].dtype == torch.float64, name
        _close_rel(name, t[name], j[name], 1e-10)
    assert all(v == 0 for v in kernels.launch_counts().values())


def test_device_none_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcompat.SimulationParameters(dim=2)
    assert tcompat.SimulationParameters(dim=2, device="cpu").device == torch.device("cpu")


@pytest.mark.parametrize("dt", [1.0, 0.5, 0.3])
def test_frame_counter_matches_jax(dt):
    t = tcompat.SimulationParameters(dim=3, dt=dt, simulation_size=(1, 1, 4, 8, 6),
                                     device="cpu")
    j = jcompat.SimulationParameters(dim=3, dt=dt, simulation_size=(1, 1, 4, 8, 6))
    runner_t, runner_j = tcompat.SimulationRunner(t), jcompat.SimulationRunner(j)
    for _ in range(7):
        runner_t.step()
        runner_j.step()
        assert (t.frame, t.time_total, t.time_per_frame) == (j.frame, j.time_total,
                                                             j.time_per_frame)
    assert t.frame == {1.0: 7, 0.5: 3, 0.3: 1}[dt] and t.get_dx() == j.get_dx() == 1.0 / 8
    assert t.is_3d() and not t.is_2d()
    with pytest.raises(ValueError, match="4 parameters"):
        tcompat.SimulationParameters(dim=2, simulation_size=(4, 4), device="cpu")


def test_3d_factories_as_the_reference():
    sp = tcompat.SimulationParameters(dim=3, simulation_size=(1, 1, 4, 4, 4), device="cpu")
    runner = tcompat.SimulationRunner(sp)
    assert runner.create_collision_MRT() is None and runner.create_collision_SC() is None
    assert runner.create_propagation().rank == 3
