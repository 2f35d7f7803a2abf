"""The port's 3D steps on the block route (``lbm_ferrofluid_tpu_torch/
parallel/step3d.py:blocks3d``, ``parallel/blocks.py``) against its
one-device steps and the JAX package's GSPMD-sharded steps, on the CPU.

Ranks are processes (``spawn``) in a gloo process group on the CPU, run by
``tests/torch_mesh_worker.py:run_mesh3d``, which imports no JAX.  The cases
(``MESH3D_CASES``): the ferrofluid step on the JAX package's
tests/test_sharding.py flagship scene (16x8x16, 5 sweeps a solve), primed
on the mesh, with h in the scalar carry and in 19 channels (tau 0.8, or
tau 1 with magnetic obstacles inside the domain), in float32 and with f, g
and h stored in bfloat16; HCZ (multiphase scene), single phase BGK and
Shan-Chen.

* Each case on (z, y) = (4, 2), (z, y, x) = (2, 2, 2), (y, x) = (2, 2)
  with z whole, and on 4 z ranks of an 8-plane grid (2-plane slabs, which
  the slab forms do not take); HCZ and the scalar carry also on 2 z ranks
  of a 6-plane grid (3-plane slabs): 3 steps through the model's entry
  point, gathered, bit for bit to the port's one-device steps on the same
  route (priming only converts h; the channel form's solve on the psi
  route, ``poisson.emit_ok`` refused, as the block route takes it);
* the solve's rounds of 2 sweeps with a remainder round of 1 (8x32x32 on
  (y, x) = (2, 2): blocks of 16 cells a split side), bit for bit, and
  ``SimulationRunner(..., mesh=)`` on the flagship scene, which primes on
  the mesh and gathers the whole state in its ``io_fn`` at every step;
* priming on the block route leaves no premac, and the exchanges a step:
  one a side and split axis for the fields of one dtype and depth;
* the flagship scene on (z, y) = (4, 2) against the JAX package's GSPMD
  step on the virtual 8-device mesh of tests/conftest.py, both primed by
  their own ``prime_premac(mesh=)`` (each converts h to the scalar carry
  and carries no premac), at atol 2e-5 + rtol 2e-4 of the field's largest
  value on f, g, vel and density, and h through ``compare_views``; HCZ on
  the same mesh against JAX's ``hcz_step`` of a sharded state;
* two or more batch elements a rank (ROADMAP A12 slice 7, ``B2_CASES``:
  the flagship scene at tau 1, which a batch keeps in 19 channels, the
  channel form in float32 and bf16 storage, HCZ, single phase, Shan-Chen)
  at B = 2 on (z, y) = (2, 2), (y, x) = (2, 2), (z, y) = (4, 2) and 4 z
  ranks of an 8-plane grid, and at B = 4 on (batch, z) = (2, 2): 3 steps
  through the model's entry point, gathered, bit for bit to the port's
  one-device batched steps on the same route, with the exchanges of B = 1
  and twice its bytes; ``SimulationRunner(..., mesh=)`` at B = 2; the
  flagship scene and HCZ at B = 2 on (z, y) = (4, 2) against the JAX
  package's GSPMD steps (f, g, h, vel, density at the same bars);
* the gates, at priming and at the step alike: a padded batch (the padded
  layout of one element steps on the block route, bit for bit) and a
  premac carried onto a block mesh; a part of two elements a rank takes the
  block route.
"""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_mesh_worker as worker  # noqa: E402
from lbm_ferrofluid_tpu import models as jmodels  # noqa: E402
from lbm_ferrofluid_tpu.ops.scalar_poisson import compare_views, h_from_scalar  # noqa: E402
from lbm_ferrofluid_tpu.parallel.mesh import make_mesh as jmake_mesh  # noqa: E402
from lbm_ferrofluid_tpu.parallel.sharding import shard_state as jshard  # noqa: E402

from lbm_ferrofluid_tpu_torch import models as pm  # noqa: E402
from lbm_ferrofluid_tpu_torch.models.state import to_numpy  # noqa: E402
from lbm_ferrofluid_tpu_torch.ops.kernels import poisson as port_poisson  # noqa: E402
from lbm_ferrofluid_tpu_torch.parallel import Mesh, shard_state, step3d  # noqa: E402

CPU = torch.device("cpu")
STEPS = 3
CASES = tuple(worker.MESH3D_CASES)
#: the cases at two or more elements a rank: "scalar" is the flagship
#: scene at tau 1, whose batch keeps h in 19 channels (the scalar carry
#: needs B == 1)
B2_CASES = ("scalar", "channel", "channel_bf16", "hcz", "bgk", "sc")
#: mesh name: (axes, shape, grid, cases at one element a rank, (batch,
#: cases) at two elements a rank)
MESHES = {
    "z4y2": (("z", "y"), (4, 2), worker.RES, CASES, (2, ("scalar", "hcz"))),
    "z2y2x2": (("z", "y", "x"), (2, 2, 2), worker.RES, CASES, (2, ())),
    "y2x2": (("y", "x"), (2, 2), worker.RES, CASES, (2, B2_CASES)),
    "z4": (("z",), (4,), (8, 8, 16), CASES, (2, B2_CASES)),
    "z2": (("z",), (2,), (6, 8, 16), ("hcz", "scalar"), (2, ())),
    "z2y2": (("z", "y"), (2, 2), worker.RES, (), (2, B2_CASES)),
    "b2z2": (("batch", "z"), (2, 2), worker.RES, (), (4, B2_CASES)),
}
#: rounds of 2 sweeps and a remainder of 1, and the runner: (mesh, job,
#: case, grid[, batch])
ROUNDS = [("y2x2", "scalar_k2", "scalar", (8, 32, 32)),
          ("y2x2", "channel_k2", "channel", (8, 32, 32)),
          ("z4y2", "runner_scalar", "scalar", worker.RES),
          ("z2y2", "runner_channel_b2", "channel", worker.RES, 2)]
#: never primed (``u19...``): a batch of 2 on (batch, z) = (2, 2), one
#: element a rank on 8-plane z-slabs, which the slab forms take (route U19:
#: the un-carried step on the 19-channel h): (mesh, job, case, grid, batch)
SLAB_JOBS = [("b2z2", "u19_scalar_b2", "scalar", worker.RES, 2),
             ("b2z2", "u19_channel_b2", "channel", worker.RES, 2)]
#: the padded layout (ROADMAP A12 slice 4c, whose own tests are
#: tests/test_torch_mesh3d_padded.py) on the meshes of the gate test, at a
#: grid whose arrays (8x8x128) split there: (mesh, job, case, physical grid)
PADDED_JOBS = [("z2y2", "padded", worker.PADDED, (6, 8, 10)),
               ("z4", "padded", worker.PADDED, (6, 8, 10))]
#: every case run on a mesh: (mesh, job, case, batch)
JOBS = [(m, c, c, 1) for m, spec in MESHES.items() for c in spec[3]] + [
    (m, f"{c}_b{spec[4][0]}", c, spec[4][0]) for m, spec in MESHES.items() for c in spec[4][1]]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{mesh: {job: the gathered arrays}} of every case (and rounds job)."""
    out = {}
    for key, (axes, shape, res, *_) in MESHES.items():
        jobs = {name: (c, res, b) for m, name, c, b in JOBS if m == key}
        jobs.update({n: (c, r, *b) for m, n, c, r, *b in ROUNDS + SLAB_JOBS + PADDED_JOBS
                     if m == key})
        out[key] = worker.run_mesh3d(tmp_path_factory.mktemp(key), axes, shape, jobs, STEPS)
    return out


@contextlib.contextmanager
def _psi_route():
    """One device's channel-form solve on the psi route (B11b's psi, the
    substitution, B10a), the route the blocks take."""
    real = port_poisson.emit_ok
    port_poisson.emit_ok = lambda *a, **kw: False
    try:
        yield
    finally:
        port_poisson.emit_ok = real


@functools.lru_cache(maxsize=None)
def _one_device(case, res, batch=1):
    """The port's one-device state after ``STEPS`` steps on the block
    route's route, as arrays: primed as the block route primes (h converted
    where the collapse applies, no premac; a batch left as it is)."""
    params, st = worker.mesh3d_state(case, res, batch)
    step = getattr(pm, worker.MESH3D_STEPS[worker.MESH3D_CASES[case][0]])
    if step is pm.ferrofluid_step:
        primed = pm.prime_premac(params, st, device="cpu")
        st = st.replace(h=primed.h, cmask=primed.cmask)
    with _psi_route():
        for _ in range(STEPS):
            st = step(params, st, device="cpu")
    return worker._flat(to_numpy(st))


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16 if a.dtype.itemsize == 2 else np.uint8)


def _assert_bits(got, want, what):
    keys = [k for k in want if np.ndim(want[k])]
    bad = [k for k in keys if got[k].shape != np.shape(want[k])
           or not np.array_equal(_bits(got[k]), _bits(want[k]))]
    assert not bad, f"{what}: fields {bad} differ from one device"


@pytest.mark.parametrize("job", JOBS, ids=[f"{m}-{n}" for m, n, _, _ in JOBS])
def test_block_steps_equal_one_device_bit_for_bit(runs, job):
    """Every case on every mesh, at one element a rank and (``_b2``,
    ``_b4``) at two, bit for bit to one device's steps of the whole batch;
    at two elements a rank the ferrofluid step keeps h in 19 channels."""
    mesh, name, case, batch = job
    got = runs[mesh][name]
    _assert_bits(got, _one_device(case, MESHES[mesh][2], batch), f"{name} on {mesh}")
    assert got["f"].shape[0] == batch
    if worker.MESH3D_CASES[case][0].startswith("ferro"):
        assert not got["stats.premac"]
        assert got["h"].shape[1] == (2 if case.startswith("scalar") and batch == 1 else 19)


@pytest.mark.parametrize("job", ROUNDS, ids=[r[1] for r in ROUNDS])
def test_solve_rounds_and_runner_bit_for_bit(runs, job):
    """The solve in rounds of 2 sweeps, and ``SimulationRunner(...,
    mesh=)``, which primes on the mesh and calls its ``io_fn`` (here a
    gather of the whole state on every rank) at every step, also at two
    elements a rank."""
    mesh, name, case, res, *batch = job
    got = runs[mesh][name]
    _assert_bits(got, _one_device(case, res, *batch), f"{name} on {mesh}")
    if name.startswith("runner"):
        assert int(got["stats.io_calls"]) == STEPS and bool(got["stats.io_whole"])
        assert not got["stats.premac"]


@pytest.mark.parametrize("job", SLAB_JOBS, ids=[r[1] for r in SLAB_JOBS])
def test_slab_route_at_one_element_a_rank_of_a_batch(runs, job):
    """A batch mesh with a z axis, one element a rank: the slab forms (route
    U19, never primed; the solve's H2 from the trailing stage of the slab
    rounds), bit for bit to one device's un-carried steps of the whole
    batch on its own route (B7's trailing stage)."""
    mesh, name, case, res, batch = job
    got = runs[mesh][name]
    params, st = worker.mesh3d_state(case, res, batch)
    for _ in range(STEPS):
        st = pm.ferrofluid_step(params, st, device="cpu")
    _assert_bits(got, worker._flat(to_numpy(st)), f"{name} on {mesh}")
    assert got["h"].shape[:2] == (batch, 19) and not got["stats.premac"]
    assert float(got["stats.exchanges"]) > 0


def test_exchanges_a_step(runs):
    """On (z, y) = (4, 2), 4 exchanges (2 sides, 2 axes) a group: the
    flagship with the scalar carry 40 (f and g; flags and magnetic flags;
    phi, rho, density and pressure; cmask and the source; 5 rounds of one
    sweep; rho_ca), HCZ 16 (f and g; flags; rho, density, pressure;
    rho_ca), single phase 4 (f); on (z, y, x) = (2, 2, 2) 6 a group.  At
    two elements a rank the same exchanges carry both elements: the
    flagship at B = 2 (the channel form, as ``channel`` at B = 1) and HCZ
    make B = 1's exchanges and send twice its bytes."""
    assert float(runs["z4y2"]["scalar"]["stats.exchanges"]) == 40
    assert float(runs["z4y2"]["channel"]["stats.exchanges"]) == 40
    assert float(runs["z4y2"]["hcz"]["stats.exchanges"]) == 16
    assert float(runs["z4y2"]["bgk"]["stats.exchanges"]) == 4
    assert float(runs["z2y2x2"]["hcz"]["stats.exchanges"]) == 24
    for two, one in (("scalar_b2", "channel"), ("hcz_b2", "hcz")):
        got, want = runs["z4y2"][two], runs["z4y2"][one]
        assert float(got["stats.exchanges"]) == float(want["stats.exchanges"]), two
        assert float(got["stats.bytes"]) == 2 * float(want["stats.bytes"]), two


def _close(got, want, name, atol=2e-5, rtol=2e-4):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    scale = np.abs(want).max() + 1e-30
    assert err <= atol + rtol * scale, f"{name}: max|err|={err:.3e} scale={scale:.3e}"


def _jax_state(case, batch=1):
    model, change = worker.MESH3D_CASES[case]
    kw, fd = worker.mesh3d_fields(model, worker.RES, batch=batch)
    p = jmodels.SimulationParams(**kw).replace(**change)
    args = (p, fd["rho"], fd["density"], fd["vel"], fd["flags"])
    if model == "hcz":
        return p, jmodels.init_hcz_state(*args)
    return p, jmodels.init_ferrofluid_state(*args, fd["magnetic_flags"])


@pytest.mark.parametrize("job", ["scalar", "hcz", "scalar_b2", "hcz_b2"])
def test_block_steps_match_jax_gspmd(runs, job):
    """The flagship scene and HCZ on (z, y) = (4, 2) against the JAX
    package's GSPMD steps of a sharded state (tests/test_sharding.py:
    94-131), each primed by its own ``prime_premac(mesh=)``; at B = 2
    (``_b2``, two elements a rank) both packages keep the flagship's h in
    19 channels and step the channel form."""
    case, _, batch = job.partition("_b")
    batch = int(batch or 1)
    p, s = _jax_state(case, batch)
    jmesh = jmake_mesh(("z", "y"), (4, 2), jax.devices()[:8])
    s = jshard(s, jmesh)
    ferro = case == "scalar"
    if ferro:
        s = jmodels.prime_premac(p, s, mesh=jmesh)
        assert s.premac is None and s.h.shape[1] == (2 if batch == 1 else 19)
    step = jmodels.ferrofluid_step if ferro else jmodels.hcz_step
    for _ in range(STEPS):
        s = step(p, s)
    jax.block_until_ready(s.f)
    assert "y" in str(s.f.sharding.spec)
    got = runs["z4y2"][job]
    assert got["f"].shape[0] == batch
    for name in ("f", "g", "vel", "density", "pressure") + (("h",) * (ferro and batch > 1)):
        _close(got[name], getattr(s, name), f"{job}: {name}")
    if ferro and batch == 1:
        flags = s.magnetic_flags
        a, b = compare_views(jnp.asarray(got["h"]), h_from_scalar(
            s.h[:, :1], s.h[:, 1:2], jnp.zeros_like(s.h[:, :1]), flags, jnp.float32), flags)
        _close(a, b, "h (collapse contract)")


def _mesh(axes, shape, rank=0):
    """This rank's mesh without a process group: for the gates, which read
    no exchange."""
    return Mesh(tuple(axes), tuple(shape), rank, CPU, "gloo")


@pytest.mark.parametrize("mesh", [("z2y2", ("z", "y"), (2, 2)), ("z4", ("z",), (4,))],
                         ids=["z2y2", "z4"])
def test_gates_at_priming_and_step(runs, mesh):
    """What the block route leaves out raises with one message at priming
    and at the step: a padded batch (as the JAX package refuses it), a
    premac carried onto the blocks (priming on the mesh carries none
    there).  The padded layout of one element steps there (ROADMAP A12
    slice 4c): its run on this mesh primed without a premac to the scalar
    h, and its 3 steps equal one device's un-carried steps bit for bit.  A
    part of two batch elements a rank takes the block route (``on_slabs``
    sends it there, on z-slabs of 4 or more planes too) and steps: the B =
    2 runs of this mesh primed on the mesh without a premac, kept h in 19
    channels and stepped to finite fields."""
    key, *mesh = mesh
    m = _mesh(*mesh)
    pp, sp = pm.rosensweig_3d_tpu(res=(6, 8, 10), batch=2, device="cpu")
    part = shard_state(sp, m)
    errors = []
    for call in (pm.prime_premac, pm.ferrofluid_step):
        with pytest.raises(NotImplementedError, match="a batch keeps the 19-channel h") as e:
            call(pp, part, mesh=m)
        errors.append(str(e.value))
    assert errors[0] == errors[1]
    padded = runs[key]["padded"]
    assert not padded["stats.premac"] and padded["h"].shape[1] == 2
    params, one = worker.mesh3d_state(worker.PADDED, (6, 8, 10))
    assert not step3d.on_slabs(m, shard_state(one, m).f.shape)
    one = pm.prime_premac(params, one, device="cpu").replace(premac=None)
    for _ in range(STEPS):
        one = pm.ferrofluid_step(params, one, device="cpu")
    _assert_bits(padded, worker._flat(to_numpy(one)), f"padded on {key}")
    p2, s2 = pm.rosensweig_3d(res=(16, 8, 16), batch=2, device="cpu")
    two = shard_state(s2, m)
    assert two.f.shape[0] == 2 and two.f.shape[2] >= 2
    assert not step3d.on_slabs(m, two.f.shape)
    assert step3d.blocks3d(m, two.f).block == tuple(two.f.shape[2:])
    for job in ("scalar_b2", "channel_bf16_b2", "hcz_b2", "bgk_b2", "sc_b2"):
        got = runs[key][job]
        assert got["f"].shape[0] == 2 and np.isfinite(got["f"].astype(np.float32)).all(), job
        if "h" in got:
            assert got["h"].shape[1] == 19 and not got["stats.premac"], job
    p1, s1 = pm.rosensweig_3d(res=(8, 8, 10), device="cpu")
    primed = shard_state(pm.prime_premac(p1, s1, device="cpu"), m)
    for route in ("Z", "E"):
        carried = worker.on_route(primed, route)
        with pytest.raises(ValueError, match="premac on the block route") as at_prime:
            pm.prime_premac(p1, carried, mesh=m)
        with pytest.raises(ValueError, match="premac on the block route") as at_step:
            pm.ferrofluid_step(p1, carried, mesh=m)
        assert str(at_prime.value) == str(at_step.value)
