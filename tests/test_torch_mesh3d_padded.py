"""The padded transposed layout (``params.phys_extent``,
``scenes.rosensweig_3d_tpu``) on split grids (ROADMAP A12 slice 4c),
against the port's one-device steps and the JAX package's meshed steps, on
the CPU.

Ranks are processes (``spawn``) in a gloo process group on the CPU, run by
``tests/torch_mesh_worker.py:run_mesh3d``, which imports no JAX.  The scene
is the JAX package's test size for the layout (tests/test_phys_extent.py:
physical 18x10x18, arrays 10x24x128, box 10x18x18; 30 sweeps a solve, as
tests/test_torch_padded.py steps it).  Each mesh primes the scene on the
mesh and takes 3 steps through ``ferrofluid_step(..., mesh=)``, gathered:

* ``("z",) = (2,)``: 5-plane slabs, the slab route.  Priming runs B4's slab
  form and leaves a 5-leaf premac and the 2-channel scalar h; each step
  solves in rounds on the slab's z-only blocks, runs B1's H2 launch, B2 and
  the plain capillary stage on the slab's part of the box, then B5's slab
  form with ``emit_mac``.  Bit for bit to a one-rank ``slab=True`` mesh.
* ``(z, y) = (2, 2)``, ``(y, x) = (2, 2)`` (rank x = 1 holds no box cell,
  rank y = 1 six box rows), ``(z, y, x) = (2, 2, 2)`` and ``("z",) = (5,)``
  (2-plane slabs): the block route, which priming leaves with no premac and
  the scalar h; each step un-carried with the box stages on the rank's part
  of the box.  Bit for bit to one device's un-carried steps.
* ``SimulationRunner(..., mesh=)`` on (z, y) = (2, 2), bit for bit too.
* The JAX package's meshed ``prime_premac(mesh=)`` and ``ferrofluid_step``
  on ``("z",) = (2,)`` (its slab route, 5-leaf premac) and ``("z", "y") =
  (2, 2)`` (GSPMD, no premac) of the virtual 8-device mesh of
  tests/conftest.py, through ``phys_view``, at atol 2e-5 + rtol 2e-4 of each
  field's largest value; h through ``compare_views``.
* The padded obstacle check over the ranks' blocks against the whole
  domain's, and a padded batch refused on a mesh as on one device.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

#: records the ids of the tests this process runs, for a mismatch's record
#: (``torch_mesh_worker.save_sides``)
pytest_plugins = ["torch_test_log"]

torch = pytest.importorskip("torch")

import torch_mesh_worker as worker  # noqa: E402
from lbm_ferrofluid_tpu import models as jmodels  # noqa: E402
from lbm_ferrofluid_tpu.models import scenes as jscenes  # noqa: E402
from lbm_ferrofluid_tpu.ops.scalar_poisson import compare_views, h_from_scalar  # noqa: E402
from lbm_ferrofluid_tpu.parallel.mesh import make_mesh as jmake_mesh  # noqa: E402
from lbm_ferrofluid_tpu.parallel.sharding import shard_state as jshard  # noqa: E402

from lbm_ferrofluid_tpu_torch import models as pm  # noqa: E402
from lbm_ferrofluid_tpu_torch.models import ferrofluid as tff  # noqa: E402
from lbm_ferrofluid_tpu_torch.models.state import to_numpy  # noqa: E402
from lbm_ferrofluid_tpu_torch.parallel import (  # noqa: E402
    Mesh,
    gather_state,
    make_mesh,
    shard_state,
)
from lbm_ferrofluid_tpu_torch.parallel.blocks import Blocks, mag_boundary_only  # noqa: E402

RES = (18, 10, 18)  # physical (z, y, x): arrays 10x24x128
STEPS = 3
#: mesh name: (axes, shape, route)
MESHES = {
    "z2": (("z",), (2,), "slabs"),
    "z2y2": (("z", "y"), (2, 2), "blocks"),
    "y2x2": (("y", "x"), (2, 2), "blocks"),
    "z2y2x2": (("z", "y", "x"), (2, 2, 2), "blocks"),
    "z5": (("z",), (5,), "blocks"),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{mesh: {job: the gathered arrays}}: the padded scene on each mesh,
    and through the runner on (z, y) = (2, 2)."""
    out = {}
    for key, (axes, shape, _) in MESHES.items():
        jobs = {"padded": (worker.PADDED, RES)}
        if key == "z2y2":
            jobs["runner_padded"] = (worker.PADDED, RES)
        out[key] = worker.run_mesh3d(tmp_path_factory.mktemp(key), axes, shape, jobs, STEPS)
    return out


def _scene():
    return pm.rosensweig_3d_tpu(res=RES, device="cpu")


@pytest.fixture(scope="module")
def one_device():
    """The port's references: one device's un-carried steps (the block
    route's route: priming only converts h) and a one-rank ``slab=True``
    mesh's steps (the slab route), as arrays."""
    torch.set_num_threads(2)
    params, st = _scene()
    blocks = pm.prime_premac(params, st, device="cpu").replace(premac=None)
    slab = make_mesh(device="cpu", slab=True)
    slabs = pm.prime_premac(params, shard_state(st, slab), mesh=slab)
    assert len(slabs.premac) == 5 and slabs.h.shape[1] == 2
    for _ in range(STEPS):
        blocks = pm.ferrofluid_step(params, blocks, device="cpu")
        slabs = pm.ferrofluid_step(params, slabs, mesh=slab)
    return {"blocks": worker._flat(to_numpy(blocks)),
            "slabs": worker._flat(to_numpy(gather_state(slabs, slab)))}


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16 if a.dtype.itemsize == 2 else np.uint8)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_padded_steps_equal_one_device_bit_for_bit(runs, one_device, mesh, tmp_path):
    """Priming on the mesh leaves a 5-leaf premac on slabs and none on
    blocks, with the 2-channel scalar h (as the JAX package's meshed
    priming); 3 steps, gathered, equal the port's one-device steps on the
    same route bit for bit, field for field (the slab route's premac too)."""
    route = MESHES[mesh][2]
    got, want = runs[mesh]["padded"], one_device[route]
    assert int(got["stats.premac_leaves"]) == (5 if route == "slabs" else 0)
    assert int(got["stats.primed_h"]) == 2 and got["h"].shape[1] == 2
    assert bool(got["stats.premac"]) == (route == "slabs")
    keys = sorted(k for k in want if np.ndim(want[k]))
    assert sorted(k for k in got if np.ndim(got[k]) and not k.startswith("stats.")) == keys
    with worker.keep_mismatch(tmp_path, f"padded on {mesh}", got, want):
        bad = [k for k in keys if got[k].shape != want[k].shape
               or not np.array_equal(_bits(got[k]), _bits(want[k]))]
        assert not bad, f"{mesh}: fields {bad} differ from one device"
    assert float(got["stats.exchanges"]) > 0


def test_runner_on_the_mesh_bit_for_bit(runs, one_device, tmp_path):
    """``SimulationRunner(..., mesh=)`` primes the padded scene on (z, y) =
    (2, 2) and gathers the whole state in its ``io_fn`` at every step; it
    ends as one device's un-carried steps, bit for bit."""
    got, want = runs["z2y2"]["runner_padded"], one_device["blocks"]
    assert int(got["stats.io_calls"]) == STEPS and bool(got["stats.io_whole"])
    assert not got["stats.premac"]
    with worker.keep_mismatch(tmp_path, "runner padded on z2y2", got, want):
        for k in ("f", "g", "h", "rho", "vel", "density", "pressure", "force", "phi"):
            assert np.array_equal(_bits(got[k]), _bits(want[k])), k


def _close(got, want, name, atol=2e-5, rtol=2e-4):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    scale = np.abs(want).max() + 1e-30
    assert err <= atol + rtol * scale, f"{name}: max|err|={err:.3e} scale={scale:.3e}"


def jax_meshed(out, axes, shape, slabs):
    """In a process of its own (``spawn``), so that its XLA compilations
    stay out of the test worker's: the JAX package's scene primed by its
    ``prime_premac(mesh=)`` on the virtual CPU devices of
    tests/conftest.py's environment and stepped ``STEPS`` times (with
    ``mesh=`` on slabs, its slab route; GSPMD else); writes the fields to
    ``out``."""
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    p, s = jscenes.rosensweig_3d_tpu(res=RES)
    jmesh = jmake_mesh(axes, shape, jax.devices()[:int(np.prod(shape))])
    s = jmodels.prime_premac(p, jshard(s, jmesh), mesh=jmesh)
    primed = dict(premac_leaves=len(s.premac or ()), h_channels=s.h.shape[1])
    for _ in range(STEPS):
        s = jmodels.ferrofluid_step(p, s, mesh=jmesh) if slabs else jmodels.ferrofluid_step(p, s)
    jax.block_until_ready(s.f)
    np.savez(out, **primed, spec=str(s.f.sharding.spec), **{
        k: np.asarray(getattr(s, k)) for k in ("f", "g", "h", "rho", "vel", "density",
                                                "pressure", "magnetic_flags")})


@pytest.mark.parametrize("mesh", ["z2", "z2y2"])
def test_padded_steps_match_jax_meshed(runs, mesh, tmp_path):
    """The JAX package's meshed steps of the same scene (:func:`jax_meshed`):
    on ``("z",) = (2,)`` its slab route (priming runs B4's slab form to a
    5-leaf premac and converts h), on ``("z", "y") = (2, 2)`` GSPMD
    (priming only converts h).  Every field through ``phys_view`` at atol
    2e-5 + rtol 2e-4 of its largest value; h through ``compare_views``."""
    import multiprocessing

    axes, shape, route = MESHES[mesh]
    proc = multiprocessing.get_context("spawn").Process(
        target=jax_meshed, args=(tmp_path / "jax.npz", axes, shape, route == "slabs"))
    proc.start()
    proc.join(600)
    assert proc.exitcode == 0, f"the JAX run exited {proc.exitcode}"
    want = np.load(tmp_path / "jax.npz")
    assert int(want["premac_leaves"]) == (5 if route == "slabs" else 0)
    assert int(want["h_channels"]) == 2 and "z" in str(want["spec"])
    p, _ = jscenes.rosensweig_3d_tpu(res=RES)
    got = runs[mesh]["padded"]
    for name, vector in (("f", False), ("g", False), ("rho", False), ("vel", True),
                         ("density", False), ("pressure", False)):
        _close(jscenes.phys_view(p, got[name], vector), jscenes.phys_view(p, want[name], vector),
               f"{mesh}: {name}")
    flags, h = jnp.asarray(want["magnetic_flags"]), jnp.asarray(want["h"])
    a, b = compare_views(jnp.asarray(got["h"]), h_from_scalar(
        h[:, :1], h[:, 1:2], jnp.zeros_like(h[:, :1]), flags, jnp.float32), flags)
    _close(a, b, f"{mesh}: h (collapse contract)")


@pytest.mark.parametrize("mesh", ["y2x2", "z2y2x2"])
def test_box_check_over_blocks_equals_whole_domain(mesh):
    """The padded obstacle check on the ranks' blocks (every cell past the
    box an obstacle, the box's interior free of them) gives the whole
    domain's answer: on the scene, with a FLUID pad cell, and with a
    magnetic obstacle inside the box, each on one rank's block."""
    axes, shape, _ = MESHES[mesh]
    params, st = _scene()
    fluid_pad, inner_obstacle = st.magnetic_flags.clone(), st.magnetic_flags.clone()
    fluid_pad[..., 4, 20, 100] = worker.FLUID
    inner_obstacle[..., 6, 14, 9] = worker.OBSTACLE
    for flags, whole in ((st.magnetic_flags, True), (fluid_pad, False),
                         (inner_obstacle, False)):
        assert tff._mag_boundary_only(flags, params.phys_extent) == whole
        parts = []
        for r in range(int(np.prod(shape))):
            # a mesh without a group: each rank's own answer, which the
            # meshed check all-reduces
            m = Mesh(tuple(axes), tuple(shape), r, torch.device("cpu"))
            part = shard_state(st.replace(magnetic_flags=flags), m)
            parts.append(mag_boundary_only(Blocks(m, part.f.shape[2:]), part.magnetic_flags,
                                           params.phys_extent))
        assert all(parts) == whole and parts.count(False) <= 1


def test_padded_batch_refused_at_priming_and_step():
    """A padded batch stays refused on a mesh, with the JAX package's reason
    (a batch keeps the 19-channel h; the channel-form solve does not take
    ``phys_extent``), at priming and at the step with one message; the
    check reads the whole batch, so one element a rank on a batch mesh
    refuses too."""
    params, st = pm.rosensweig_3d_tpu(res=(6, 8, 10), batch=2, device="cpu")
    for axes, shape in ((("batch", "z"), (2, 2)), (("z", "y"), (2, 2)), (("batch",), (2,))):
        m = Mesh(axes, shape, 0, torch.device("cpu"), "gloo")
        part = shard_state(st, m)
        errors = []
        for call in (pm.prime_premac, pm.ferrofluid_step):
            with pytest.raises(NotImplementedError, match="a batch keeps the 19-channel h") as e:
                call(params, part, mesh=m)
            errors.append(str(e.value))
        assert errors[0] == errors[1] and "a batch of 2" in errors[0], axes
