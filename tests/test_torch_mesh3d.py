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
* the gates, at priming and at the step alike: the padded layout on a split
  grid (slice 4c), more than one batch element a rank (slice 7), a premac
  carried onto a block mesh.
"""

import contextlib

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
from lbm_ferrofluid_tpu_torch.parallel import Mesh, shard_state  # noqa: E402

CPU = torch.device("cpu")
STEPS = 3
CASES = tuple(worker.MESH3D_CASES)
#: mesh name: (axes, shape, grid, cases)
MESHES = {
    "z4y2": (("z", "y"), (4, 2), worker.RES, CASES),
    "z2y2x2": (("z", "y", "x"), (2, 2, 2), worker.RES, CASES),
    "y2x2": (("y", "x"), (2, 2), worker.RES, CASES),
    "z4": (("z",), (4,), (8, 8, 16), CASES),
    "z2": (("z",), (2,), (6, 8, 16), ("hcz", "scalar")),
}
#: rounds of 2 sweeps and a remainder of 1, and the runner: (mesh, job,
#: case, grid)
ROUNDS = [("y2x2", "scalar_k2", "scalar", (8, 32, 32)),
          ("y2x2", "channel_k2", "channel", (8, 32, 32)),
          ("z4y2", "runner_scalar", "scalar", worker.RES)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{mesh: {job: the gathered arrays}} of every case (and rounds job)."""
    out = {}
    for key, (axes, shape, res, cases) in MESHES.items():
        jobs = {c: (c, res) for c in cases}
        jobs.update({n: (c, r) for m, n, c, r in ROUNDS if m == key})
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


def _one_device(case, res):
    """The port's one-device state after ``STEPS`` steps on the block
    route's route, as arrays: primed as the block route primes (h converted
    where the collapse applies, no premac)."""
    params, st = worker.mesh3d_state(case, res)
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


@pytest.mark.parametrize("job", [(m, c) for m, spec in MESHES.items() for c in spec[3]],
                         ids=[f"{m}-{c}" for m, spec in MESHES.items() for c in spec[3]])
def test_block_steps_equal_one_device_bit_for_bit(runs, job):
    mesh, case = job
    got = runs[mesh][case]
    _assert_bits(got, _one_device(case, MESHES[mesh][2]), f"{case} on {mesh}")
    if worker.MESH3D_CASES[case][0].startswith("ferro"):
        assert not got["stats.premac"]
        assert got["h"].shape[1] == (2 if case.startswith("scalar") else 19)


@pytest.mark.parametrize("job", ROUNDS, ids=[r[1] for r in ROUNDS])
def test_solve_rounds_and_runner_bit_for_bit(runs, job):
    """The solve in rounds of 2 sweeps, and ``SimulationRunner(...,
    mesh=)``, which primes on the mesh and calls its ``io_fn`` (here a
    gather of the whole state on every rank) at every step."""
    mesh, name, case, res = job
    got = runs[mesh][name]
    _assert_bits(got, _one_device(case, res), f"{name} on {mesh}")
    if name.startswith("runner"):
        assert int(got["stats.io_calls"]) == STEPS and bool(got["stats.io_whole"])
        assert not got["stats.premac"]


def test_exchanges_a_step(runs):
    """On (z, y) = (4, 2), 4 exchanges (2 sides, 2 axes) a group: the
    flagship with the scalar carry 40 (f and g; flags and magnetic flags;
    phi, rho, density and pressure; cmask and the source; 5 rounds of one
    sweep; rho_ca), HCZ 16 (f and g; flags; rho, density, pressure;
    rho_ca), single phase 4 (f); on (z, y, x) = (2, 2, 2) 6 a group."""
    assert float(runs["z4y2"]["scalar"]["stats.exchanges"]) == 40
    assert float(runs["z4y2"]["channel"]["stats.exchanges"]) == 40
    assert float(runs["z4y2"]["hcz"]["stats.exchanges"]) == 16
    assert float(runs["z4y2"]["bgk"]["stats.exchanges"]) == 4
    assert float(runs["z2y2x2"]["hcz"]["stats.exchanges"]) == 24


def _close(got, want, name, atol=2e-5, rtol=2e-4):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    scale = np.abs(want).max() + 1e-30
    assert err <= atol + rtol * scale, f"{name}: max|err|={err:.3e} scale={scale:.3e}"


def _jax_state(case):
    model, change = worker.MESH3D_CASES[case]
    kw, fd = worker.mesh3d_fields(model, worker.RES)
    p = jmodels.SimulationParams(**kw).replace(**change)
    args = (p, fd["rho"], fd["density"], fd["vel"], fd["flags"])
    if model == "hcz":
        return p, jmodels.init_hcz_state(*args)
    return p, jmodels.init_ferrofluid_state(*args, fd["magnetic_flags"])


@pytest.mark.parametrize("case", ["scalar", "hcz"])
def test_block_steps_match_jax_gspmd(runs, case):
    """The flagship scene and HCZ on (z, y) = (4, 2) against the JAX
    package's GSPMD steps of a sharded state (tests/test_sharding.py:
    94-131), each primed by its own ``prime_premac(mesh=)``."""
    p, s = _jax_state(case)
    jmesh = jmake_mesh(("z", "y"), (4, 2), jax.devices()[:8])
    s = jshard(s, jmesh)
    ferro = case == "scalar"
    if ferro:
        s = jmodels.prime_premac(p, s, mesh=jmesh)
        assert s.premac is None and s.h.shape[1] == 2
    step = jmodels.ferrofluid_step if ferro else jmodels.hcz_step
    for _ in range(STEPS):
        s = step(p, s)
    jax.block_until_ready(s.f)
    assert "y" in str(s.f.sharding.spec)
    got = runs["z4y2"][case]
    for name in ("f", "g", "vel", "density", "pressure"):
        _close(got[name], getattr(s, name), f"{case}: {name}")
    if ferro:
        flags = s.magnetic_flags
        a, b = compare_views(jnp.asarray(got["h"]), h_from_scalar(
            s.h[:, :1], s.h[:, 1:2], jnp.zeros_like(s.h[:, :1]), flags, jnp.float32), flags)
        _close(a, b, "h (collapse contract)")


def _mesh(axes, shape, rank=0):
    """This rank's mesh without a process group: for the gates, which read
    no exchange."""
    return Mesh(tuple(axes), tuple(shape), rank, CPU, "gloo")


@pytest.mark.parametrize("mesh", [(("z", "y"), (2, 2)), (("z",), (4,))], ids=["z2y2", "z4"])
def test_gates_at_priming_and_step(mesh):
    """What the block route leaves out raises with one message at priming
    and at the step: the padded layout on a split grid (ROADMAP A12 slice
    4c), more than one batch element a rank (slice 7), a premac carried
    onto the blocks (priming on the mesh carries none there)."""
    m = _mesh(*mesh)
    pp, sp = pm.rosensweig_3d_tpu(res=(8, 8, 10), device="cpu")
    part = shard_state(sp, m)
    for call in (pm.prime_premac, pm.ferrofluid_step):
        with pytest.raises(NotImplementedError, match="ROADMAP A12 slice 4c"):
            call(pp, part, mesh=m)
    p2, s2 = pm.rosensweig_3d(res=(8, 8, 10), batch=2, device="cpu")
    two = shard_state(s2, m)
    messages = set()
    for call in (pm.prime_premac, pm.ferrofluid_step):
        with pytest.raises(NotImplementedError, match="ROADMAP A12 slice 7") as e:
            call(p2, two, mesh=m)
        messages.add(str(e.value))
    ph, sh = pm.multiphase_3d(res=(8, 8, 10), batch=2, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP A12 slice 7") as e:
        pm.hcz_step(ph, shard_state(sh, m), mesh=m)
    messages.add(str(e.value))
    assert len(messages) == 1
    p1, s1 = pm.rosensweig_3d(res=(8, 8, 10), device="cpu")
    primed = shard_state(pm.prime_premac(p1, s1, device="cpu"), m)
    for route in ("Z", "E"):
        carried = worker.on_route(primed, route)
        with pytest.raises(ValueError, match="premac on the block route") as at_prime:
            pm.prime_premac(p1, carried, mesh=m)
        with pytest.raises(ValueError, match="premac on the block route") as at_step:
            pm.ferrofluid_step(p1, carried, mesh=m)
        assert str(at_prime.value) == str(at_step.value)
