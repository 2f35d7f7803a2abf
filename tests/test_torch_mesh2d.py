"""The port's 2D models on y/x meshes (``lbm_ferrofluid_tpu_torch/parallel/
step2d.py``) against its one-device steps and the JAX package's
GSPMD-sharded steps, on the CPU.

Ranks are processes (``spawn``) in a gloo process group on the CPU, run by
``tests/torch_mesh_worker.py:run_mesh2d``, which imports no JAX.  The
cases (``MESH2D_CASES``): single phase BGK and KBC on the JAX package's
tests/test_sharding.py scene (32x16), Shan-Chen, HCZ on that file's scene
(16x24) and on a wetting floor with KBC on g, and the ferrofluid step with
h in the scalar carry (primed), in 9 channels, and in bfloat16 storage.

* Each case on ``(y, x) = (4, 2)`` and ``(2, 4)`` (the JAX tests' meshes),
  on ``(batch, y, x) = (2, 2, 1)`` (a batch of 2 whose elements differ)
  and on ``(y, x) = (2, 2)`` with both elements of a batch of 2 on every
  rank (``y2x2b2``), 5 steps through the model's entry point, gathered:
  bit for bit to the port's one-device steps (at the batch mesh each
  element to its own one-element steps, since each rank primes its own
  element as one device primes one element; on ``y2x2b2`` to one device's
  batched steps, which keep a batch's h in 9 channels);
* against the JAX package's own GSPMD-sharded steps on the same mesh over
  the 8 virtual CPU devices of tests/conftest.py, inputs from the same
  numpy seed, at the bar of tests/test_torch_ferro2d.py:284 (atol 2e-5 +
  rtol 2e-4 of the field's largest value); each float32 case on one mesh
  (a JAX compile of a meshed step takes seconds); bfloat16 storage is held
  to JAX by tests/test_torch_bf16_slice.py;
* the seams: the HCZ scene's contact angle on grids whose split puts a seam
  1 cell (blocks of 1 column, of 1 row) and 2 cells from a true edge, the
  ghosts crossing several ranks, and the Poisson solve in rounds of 2 and
  of 4 sweeps with a remainder round, bit for bit;
* ``SimulationRunner(..., mesh=)`` primes and steps a rank's block as
  the direct calls do;
* exchanges a step: one a side and axis for the fields of one dtype;
* ``shard_state`` then ``gather_state`` along y and x gives the state back,
  with ``H_ext_mac`` cut only along the axis it divides;
* the gates: a block of 1x1 cells, a grid that does not divide, a padded
  batch on a y/x mesh (the padded layout of one element steps there,
  tests/test_torch_mesh3d_padded.py), a 2D state on a z mesh;
  a mesh of z with y (the default axes), and a 3D state on a y/x mesh
  routed to the block route (its steps: tests/test_torch_mesh3d.py), where
  a state primed on one device refuses at priming and step alike.
"""

import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_mesh_worker as worker  # noqa: E402
from lbm_ferrofluid_tpu import models as jmodels  # noqa: E402
from lbm_ferrofluid_tpu.parallel.mesh import make_mesh as jmake_mesh  # noqa: E402
from lbm_ferrofluid_tpu.parallel.sharding import shard_state as jshard  # noqa: E402

from lbm_ferrofluid_tpu_torch import models as pm  # noqa: E402
from lbm_ferrofluid_tpu_torch.models.multiphase import mesh_blocks  # noqa: E402
from lbm_ferrofluid_tpu_torch.models.state import to_numpy  # noqa: E402
from lbm_ferrofluid_tpu_torch.parallel import Mesh, make_mesh, shard_state, step3d  # noqa: E402

CPU = torch.device("cpu")
STEPS = 5
MESHES = {"y4x2": (("y", "x"), (4, 2)), "y2x4": (("y", "x"), (2, 4)),
          "b2y2x1": (("batch", "y", "x"), (2, 2, 1)), "y2x2b2": (("y", "x"), (2, 2))}
#: the meshes whose cases run a batch of 2: one element a rank on the batch
#: mesh, both elements on every rank of y2x2b2
BATCHES = {"b2y2x1": 2, "y2x2b2": 2}
CASES = tuple(worker.MESH2D_CASES)
#: the seam jobs (name: case, grid) on the mesh of the key: blocks of 1
#: column (16x4 on y2x4) and of 2 (8x8), of 1 row (4x6 on y4x2), whose
#: 3-cell ghosts cross several ranks; the solve's rounds of 2 sweeps
#: (64x48: 16x24 blocks) and of 4 with a remainder round of 2 (128x64:
#: 32x32 blocks); the scalar case through ``SimulationRunner(..., mesh=)``
SEAMS = {
    "y2x4": {"hcz_col1": ("hcz", (16, 4)), "hcz_col2": ("hcz", (8, 8)),
             "scalar_col1": ("scalar", (16, 4)), "runner_scalar": ("scalar", None)},
    "y4x2": {"hcz_row1": ("hcz", (4, 6)), "hcz_kbc_row1": ("hcz_kbc", (4, 6)),
             "channel_row1": ("channel", (4, 6)), "channel_k2": ("channel", (64, 48)),
             "scalar_k4": ("scalar", (128, 64))},
}
#: the float32 cases held to the JAX package's GSPMD steps, by mesh (the
#: batch mesh takes cases that are not primed: JAX primes a batch of 2 as
#: it is, the port's ranks their one element each)
JAX_CASES = {"y4x2": ("bgk", "sc", "scalar"), "y2x4": ("hcz", "kbc", "channel"),
             "b2y2x1": ("hcz_kbc", "sc")}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{mesh: {job: the gathered arrays}} of every case (and seam job)."""
    out = {}
    for key, (axes, shape) in MESHES.items():
        jobs = {c: (c, BATCHES.get(key, 1), None) for c in CASES}
        jobs.update({n: (c, 1, res) for n, (c, res) in SEAMS.get(key, {}).items()})
        if key == "y4x2":
            jobs["roundtrip"] = ("channel", 1, None)
        out[key] = worker.run_mesh2d(tmp_path_factory.mktemp(key), axes, shape, jobs, STEPS)
    return out


def _one_device(case, batch=1, res=None, element=None):
    """The port's one-device state after ``STEPS`` steps, as arrays: of the
    whole batch, or of one element stepped alone (``element``)."""
    params, st = worker.mesh2d_state(case, batch, res)
    if element is not None:
        st = dataclasses.replace(st, **{
            f.name: worker_slice(getattr(st, f.name), element)
            for f in dataclasses.fields(st) if f.name != "step"})
    step = getattr(pm, worker.MESH2D_STEPS[worker.MESH2D_CASES[case][0]])
    if worker.MESH2D_CASES[case][3]:
        st = pm.prime_premac(params, st, device="cpu")
    for _ in range(STEPS):
        st = step(params, st, device="cpu")
    return worker._flat(to_numpy(st))


def worker_slice(v, b):
    if v is None:
        return None
    if isinstance(v, tuple):
        return tuple(worker_slice(x, b) for x in v)
    return v[b:b + 1] if v.shape[0] == 2 else v


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16 if a.dtype.itemsize == 2 else np.uint8)


def _assert_bits(got, want, what):
    keys = [k for k in want if np.ndim(want[k])]
    bad = [k for k in keys if got[k].shape != np.shape(want[k])
           or not np.array_equal(_bits(got[k]), _bits(want[k]))]
    assert not bad, f"{what}: fields {bad} differ from one device"


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("case", CASES)
def test_meshed_steps_equal_one_device_bit_for_bit(runs, mesh, case):
    got = runs[mesh][case]
    if MESHES[mesh][0][0] != "batch":
        _assert_bits(got, _one_device(case, BATCHES.get(mesh, 1)), f"{case} on {mesh}")
        assert got["f"].shape[0] == BATCHES.get(mesh, 1)
        return
    for b in range(2):
        want = _one_device(case, 2, element=b)
        _assert_bits({k: v[b:b + 1] if np.ndim(v) and v.shape[0] == 2 else v
                      for k, v in got.items()}, want, f"{case} on {mesh}, element {b}")


@pytest.mark.parametrize("job", [(m, n) for m, jobs in SEAMS.items() for n in jobs])
def test_seams_and_rounds_bit_for_bit(runs, job):
    mesh, name = job
    case, res = SEAMS[mesh][name]
    _assert_bits(runs[mesh][name], _one_device(case, 1, res), f"{name} on {mesh}")


def test_exchanges_a_step(runs):
    """Single phase: f and the flags, two dtypes, each one exchange a side
    and axis (8); the channel form at one sweep a round on 4x2 ranks (4x12
    blocks): 152 (the stream 12, the source 8, 30 sweeps 120, H2 4, the
    contact angle 4, the capillary stage 4); in rounds of 2 sweeps (16x24
    blocks) 15 rounds of 4: 92."""
    assert float(runs["y4x2"]["bgk"]["stats.exchanges"]) == 8
    assert float(runs["y4x2"]["channel"]["stats.exchanges"]) == 152
    assert float(runs["y4x2"]["channel_k2"]["stats.exchanges"]) == 152 - 120 + 60


def _jax_state(case, batch):
    model, res, change, prime = worker.MESH2D_CASES[case]
    kw, fd = worker.mesh2d_fields(model, res, batch)
    p = jmodels.SimulationParams(**kw).replace(**change)
    if model == "single":
        return p, jmodels.init_singlephase_state(p, fd["rho"], fd["vel"], fd["flags"])
    args = (p, fd["rho"], fd["density"], fd["vel"], fd["flags"])
    if model == "sc":
        return p, jmodels.init_sc_state(*args)
    if model == "ferro":
        return p, jmodels.init_ferrofluid_state(*args, fd["magnetic_flags"])
    return p, jmodels.init_hcz_state(*args)


JSTEPS = {"single": "singlephase_step", "sc": "sc_step", "hcz": "hcz_step",
          "hcz_kbc": "hcz_step", "ferro": "ferrofluid_step"}


def _close(got, want, name, atol=2e-5, rtol=2e-4):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    scale = np.abs(want).max() + 1e-30
    assert err <= atol + rtol * scale, f"{name}: max|err|={err:.3e} scale={scale:.3e}"


@pytest.mark.parametrize("job", [(m, c) for m, cs in JAX_CASES.items() for c in cs])
def test_meshed_steps_match_jax_gspmd(runs, job):
    mesh, case = job
    axes, shape = MESHES[mesh]
    model, _, _, prime = worker.MESH2D_CASES[case]
    p, s = _jax_state(case, 2 if axes[0] == "batch" else 1)
    s = jshard(s, jmake_mesh(axes, shape, jax.devices()[:int(np.prod(shape))]))
    if prime:
        s = jmodels.prime_premac(p, s)
    step = getattr(jmodels, JSTEPS[model])
    for _ in range(STEPS):
        s = step(p, s)
    jax.block_until_ready(s.f)
    assert "y" in str(s.f.sharding.spec)
    got = runs[mesh][case]
    for name in ("f", "g", "rho", "vel", "density", "pressure", "force"):
        want = getattr(s, name, None)
        if want is not None:
            _close(got[name], want, f"{case} on {mesh}: {name}")
    if model == "ferro":
        assert got["h"].shape == s.h.shape
        _close(got["h"], s.h, f"{case} on {mesh}: h")


def test_shard_gather_round_trip(runs):
    got = runs["y4x2"]["roundtrip"]
    _, whole = worker.mesh2d_state("channel")
    _assert_bits(got, worker._flat(to_numpy(whole)), "round trip")
    # H_ext_mac: the x-staggered leaf (16 x 25) cut along y only, the
    # y-staggered one (17 x 24) along x only
    assert got["mac_shapes"].tolist() == [[1, 1, 4, 25], [1, 1, 17, 12]]


def _mesh(axes, shape, rank=0):
    """This rank's mesh without a process group: for the gates, which
    exchange nothing."""
    return Mesh(tuple(axes), tuple(shape), rank, CPU, "gloo")


def test_gates_and_refusals():
    p, s = worker.mesh2d_state("hcz", res=(2, 2))
    mesh = _mesh(("y", "x"), (2, 2))
    with pytest.raises(ValueError, match="a block of 1x1 cells"):
        pm.hcz_step(p, shard_state(s, mesh), mesh=mesh)
    p, s = worker.mesh2d_state("hcz")
    with pytest.raises(ValueError, match="Y=16 does not split over the mesh's y axis of 3"):
        shard_state(s, _mesh(("y", "x"), (3, 1)))
    with pytest.raises(ValueError, match="X=24 does not split over the mesh's x axis of 5"):
        shard_state(s, _mesh(("y", "x"), (1, 5)))
    # z with y or x is a mesh (3D states step on its blocks,
    # tests/test_torch_mesh3d.py), and ("z", "y") the default axes, as JAX's
    assert make_mesh(("z", "y"), (1, 1), device="cpu").axis_names == ("z", "y")
    assert make_mesh(device="cpu").axis_names == ("z", "y")
    with pytest.raises(NotImplementedError, match="split along y and x"):
        shard_state(s, _mesh(("batch", "z"), (1, 2)))
    slab = make_mesh(device="cpu", slab=True)
    with pytest.raises(NotImplementedError, match="split along y and x"):
        pm.hcz_step(p, s, mesh=slab)
    # a 3D state on a y/x mesh takes the block route, stepped bit for bit to
    # one device in tests/test_torch_mesh3d.py; here its dispatch, and its
    # gate that reads no exchange: a state primed on one device refuses at
    # priming and at the step with one message
    yx = _mesh(("y", "x"), (2, 1))
    p3, s3 = pm.rosensweig_3d(res=(8, 8, 10), device="cpu")
    part = shard_state(s3, yx)
    assert not step3d.on_slabs(yx, part.f.shape)
    assert mesh_blocks(p3, part, yx, None).block == (8, 4, 10)
    primed = shard_state(pm.prime_premac(p3, s3, device="cpu"), yx)
    with pytest.raises(ValueError, match="premac on the block route") as at_step:
        pm.ferrofluid_step(p3, primed, mesh=yx)
    with pytest.raises(ValueError, match="premac on the block route") as at_prime:
        pm.prime_premac(p3, primed, mesh=yx)
    assert str(at_step.value) == str(at_prime.value)
    ph, sh = pm.multiphase_3d(res=(8, 8, 10), device="cpu")
    blk = mesh_blocks(ph, shard_state(sh, yx), yx, None)
    assert (blk.block, list(blk.split)) == ((8, 4, 10), [3])
    pp, sp = pm.rosensweig_3d_tpu(res=(6, 8, 10), batch=2, device="cpu")
    with pytest.raises(NotImplementedError, match="a batch keeps the 19-channel h"):
        pm.prime_premac(pp, shard_state(sp, yx), mesh=yx)
    params = pm.SimulationParams(dim=3, tau=0.6)
    res = (1, 1, 8, 8, 10)
    rho, flags = np.full(res, 0.2, np.float32), np.ones(res, np.uint8)
    vel = np.zeros((1, 3, *res[2:]), np.float32)
    for st in (pm.init_singlephase_state(params, rho, vel, flags, device="cpu"),
               pm.init_sc_state(params, rho, rho, vel, flags, device="cpu")):
        assert mesh_blocks(params, shard_state(st, yx), yx, None).block == (8, 4, 10)
