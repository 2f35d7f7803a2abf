"""The port's meshed channel-form solve and HCZ step (ROADMAP A12 slices 2
and 3) against the JAX package, on the CPU.

Ranks are processes (``spawn``) in a gloo process group on the CPU, run by
``tests/torch_mesh_worker.py`` (``run_routes``), which imports no JAX; one
job a mesh runs several routes in turn.  Routes (the worker's
``CHANNEL_ROUTES`` and ``HCZ_ROUTES``): on the JAX package's flagship scene
for its sharded tests (16x8x16), C the capillogue steady state with a
19-channel h (``scalar_carry=False``, tau 0.8: B11b's slab rounds, the
substitution, B10a, B2, B3), U19 the un-carried step on that h (B4, the
same solve, B2, B10b, B6, B5) and CM route C where an interior magnetic
obstacle on the slabs' inner face planes keeps h in 19 channels (tau 1);
and the HCZ step (B8b, B8a, B2, B10b, B6 in slab form, B9 local) on
``multiphase_3d`` with velocities pinned across the inner faces (H) and
on ``droplet_spread_3d``, gravity and the wetting floor (HD), at 16x8x12.

* 2 z ranks (3 sweeps a solve: one round of B11b) and 4 (6 sweeps: two
  rounds, the emitted bands exchanged between them; CM's obstacles then
  lie on every slab's edge planes, which only the whole domain's check
  sees): prime as the route
  asks and 3 steps, gathered, against 3 JAX single-device steps
  (``use_pallas=False``) at tests/test_sharded_step.py's bars, rtol 2e-5
  and atol 1e-6, h compared directly; and bit for bit against 3 of the
  port's single-device steps, since every cell's arithmetic is the same
  (on the CPU the kernels' wrappers run their plain versions on one device
  as on a slab).
* One rank with ``slab=True`` (the slab forms with the rank's own wrap as
  ghosts) on routes C, U19 and H, bit for bit to the single-device steps.
* The gates: the HCZ step on slabs under 4 planes takes the block route.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

#: records the ids of the tests this process runs, for a mismatch's record
#: (``torch_mesh_worker.save_sides``)
pytest_plugins = ["torch_test_log"]

torch = pytest.importorskip("torch")

import torch_mesh_worker as worker  # noqa: E402
from lbm_ferrofluid_tpu.models import SimulationParams as JParams  # noqa: E402
from lbm_ferrofluid_tpu.models import ferrofluid_step as jstep  # noqa: E402
from lbm_ferrofluid_tpu.models import hcz_step as jhcz_step  # noqa: E402
from lbm_ferrofluid_tpu.models import init_ferrofluid_state as jinit  # noqa: E402
from lbm_ferrofluid_tpu.models import scenes as jscenes  # noqa: E402

from lbm_ferrofluid_tpu_torch.models import multiphase_3d  # noqa: E402
from lbm_ferrofluid_tpu_torch.parallel import Mesh, make_mesh, shard_state, step3d  # noqa: E402

STEPS = 3
FERRO = ("f", "g", "h", "rho", "vel", "density", "pressure")
HCZ = ("f", "g", "rho", "vel", "density", "pressure", "force")
#: the meshes: (z ranks, sweeps a solve, routes of its job)
JOBS = {2: (3, worker.CHANNEL_ROUTES + worker.HCZ_ROUTES),
        4: (6, worker.CHANNEL_ROUTES + worker.HCZ_ROUTES)}
CASES = [(r, nz) for nz, (_, routes) in JOBS.items() for r in routes]


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def meshed(tmp_path_factory):
    """{nz: {route: the gathered state after 3 meshed steps}}: one job of
    gloo ranks a mesh."""
    return {nz: worker.run_routes(nz, tmp_path_factory.mktemp(f"nz{nz}"), routes, iters, STEPS)
            for nz, (iters, routes) in JOBS.items()}


def _jax_state(route, iters):
    """The JAX package's scene of ``route`` and its step, at the route's
    configuration (its pins given to the JAX state as to the port's)."""
    if route in worker.HCZ_ROUTES:
        build = jscenes.multiphase_3d if route == "H" else jscenes.droplet_spread_3d
        params, state = build(res=worker.HCZ_RES)
        if route == "H":
            mask, value = worker.hcz_pins()
            state = dataclasses.replace(state, vel_pin_mask=jnp.asarray(mask),
                                        vel_pin_value=jnp.asarray(value))
        return params.replace(use_pallas=False), state, jhcz_step
    kw, fields = worker.channel_config(route)
    params = JParams(poisson_iters=iters, **kw).replace(use_pallas=False)
    return params, jinit(params, *fields), jstep


@pytest.fixture(scope="module")
def jax_steps():
    """{(route, sweeps): 3 JAX single-device steps} (C and U19 share them:
    the JAX step of an unprimed state is the un-carried one)."""
    out = {}
    for route, nz in CASES:
        iters = JOBS[nz][0]
        key = ("C" if route == "U19" else route, iters)
        if key not in out:
            params, s, step = _jax_state(route, iters)
            for _ in range(STEPS):
                s = step(params, s)
            out[key] = s
    return out


def port_steps(route, iters):
    params, s, step = worker.route_state(route, iters)
    s = worker.prime_route(params, s, route, device="cpu")
    for _ in range(STEPS):
        s = step(params, s, device="cpu")
    return s


def _fields(route):
    return HCZ if route in worker.HCZ_ROUTES else FERRO


@pytest.mark.parametrize("route,nz", CASES, ids=[f"{r}-nz{nz}" for r, nz in CASES])
def test_meshed_route_matches_jax(route, nz, meshed, jax_steps):
    """Prime and 3 steps on nz gloo ranks against 3 JAX single-device steps
    at tests/test_sharded_step.py's bars, h compared directly."""
    got = meshed[nz][route]
    iters = JOBS[nz][0]
    want = jax_steps[("C" if route == "U19" else route, iters)]
    if route not in worker.HCZ_ROUTES:
        assert got["h"].shape[1] == 19
        assert {k for k in got if k.startswith("premac.")} == (
            set() if route == "U19" else {f"premac.{i}" for i in range(6)})
    for name in _fields(route):
        np.testing.assert_allclose(got[name], np.asarray(getattr(want, name)), rtol=2e-5,
                                   atol=1e-6, err_msg=name)


@pytest.mark.parametrize("route,nz", CASES, ids=[f"{r}-nz{nz}" for r, nz in CASES])
def test_meshed_route_bit_for_bit(route, nz, meshed, tmp_path):
    """The same ranks' gathered state equals 3 of the port's single-device
    steps bit for bit, premac too."""
    got = meshed[nz][route]
    ref = port_steps(route, JOBS[nz][0])
    want = worker.named_fields(ref, _fields(route))
    with worker.keep_mismatch(tmp_path, f"{route} nz{nz}", got, want):
        for name in _fields(route):
            np.testing.assert_array_equal(got[name], getattr(ref, name).numpy(), err_msg=name)
        for i, leaf in enumerate(getattr(ref, "premac", None) or ()):
            np.testing.assert_array_equal(got[f"premac.{i}"], leaf.numpy(),
                                          err_msg=f"premac {i}")


@pytest.mark.parametrize("route", ["C", "U19", "H"])
def test_slab_forced_route_matches(route, tmp_path):
    """One rank with ``slab=True``: every slab form, its ghosts the rank's
    own wrap and both z edges true, bit for bit to the single-device
    steps."""
    mesh = make_mesh(device="cpu", slab=True)
    params, s, step = worker.route_state(route, 3)
    s = worker.prime_route(params, shard_state(s, mesh), route, mesh=mesh)
    for _ in range(STEPS):
        s = step(params, s, mesh=mesh)
    ref = port_steps(route, 3)
    with worker.keep_mismatch(tmp_path, f"{route} slab", worker.named_fields(s, _fields(route)),
                              worker.named_fields(ref, _fields(route))):
        for name in _fields(route):
            assert torch.equal(getattr(s, name), getattr(ref, name)), name


def test_hcz_step_gates():
    """The HCZ step takes the slab forms on 4 or more planes a rank, and
    the block route on thinner slabs (stepped bit for bit to one device in
    tests/test_torch_mesh3d.py)."""
    params, s = multiphase_3d(res=(12, 8, 10), device="cpu")
    thin = Mesh(("batch", "z"), (1, 4), 1, torch.device("cpu"), "gloo", False)
    part = shard_state(s, thin)
    assert not step3d.on_slabs(thin, part.f.shape)
    assert step3d.blocks3d(thin, part.f).block == (3, 8, 10)
    slabs = Mesh(("batch", "z"), (1, 3), 1, torch.device("cpu"), "gloo", False)
    assert step3d.on_slabs(slabs, shard_state(s, slabs).f.shape)
