"""The port's meshed step (``lbm_ferrofluid_tpu_torch/parallel``) against the
JAX package, on the CPU.

Ranks are processes (``spawn``) in a gloo process group on the CPU, run by
``tests/torch_mesh_worker.py``, which imports no JAX.  On the JAX package's
own scene for its sharded tests (tests/test_sharded_step.py:_flagship,
16x8x16 with ``mag_flags_shell``):

* 2 z ranks (3 sweeps a solve: one round of B1) and 4 z ranks (6 sweeps:
  two rounds, so the bands' exchange between rounds runs): prime and 3
  steps, gathered, against 3 JAX single-device steps (``use_pallas=False``)
  at that file's bars, rtol 2e-5 and atol 1e-6, with h through
  ``compare_views``; and against 3 of the port's single-device steps bit for
  bit, since every cell's arithmetic is the same.  Route Z (the capillogue
  steady state) at 2 and 4 ranks; the epilogue routes (B10b, B6 and B5 in
  slab form) at 2 ranks: E (the 5-leaf epilogue steady state), O (an
  out-of-plane field, its Poisson source a z-stencil across the faces:
  against JAX's steps of the same field, and bit for bit against the
  port's single-device route, the capillogue's box form, whose plain
  versions compute the same cells) and U (the un-carried step with the
  scalar carry); E at 4 ranks too;
* the sharded checkpoint resume (2 z ranks, routes Z and E): gather, save,
  load into a freshly primed template, re-cut and step, equal to the
  uninterrupted run bit for bit;
* a batch mesh (2, 1) of a batch-2 state against the JAX single-device
  steps of each element, and one rank with ``slab=True`` (the slab forms
  with the rank's own wrap as ghosts) bit for bit to the single-device
  steps;
* ``halo.sharded_poisson_sweeps`` on 2 gloo z ranks against the JAX
  package's single-device channel-form loop (tests/test_halo.py's bars);
* the gates and refusals: Z not divisible by nz, slabs under 4 planes and
  z together with y routed to the block route, and the routes the slab
  mesh does not run (the padded layout and 2D); the step's gates are
  priming's (a state primed on one device and cut onto 3- and 2-plane
  slabs, which take the block route, ROADMAP C7); ``auto_mesh_shape``
  against JAX's; ``initialize_distributed`` without torchrun's variables;
* a kernel's launch is refused for a tensor off the current card
  (``_lib.stream_of``), held with a fake card index.
"""

import ast
import pathlib
import types

import jax.numpy as jnp  # noqa: F401  (JAX on the CPU, as conftest sets it)
import numpy as np
import pytest

#: records the ids of the tests this process runs, for a mismatch's record
#: (``torch_mesh_worker.save_sides``)
pytest_plugins = ["torch_test_log"]

torch = pytest.importorskip("torch")

import torch_mesh_worker as worker  # noqa: E402
from lbm_ferrofluid_tpu.models import SimulationParams as JParams  # noqa: E402
from lbm_ferrofluid_tpu.models import ferrofluid_step as jstep  # noqa: E402
from lbm_ferrofluid_tpu.models import init_ferrofluid_state as jinit  # noqa: E402
from lbm_ferrofluid_tpu.ops.scalar_poisson import compare_views  # noqa: E402
from lbm_ferrofluid_tpu.parallel.mesh import auto_mesh_shape as jauto  # noqa: E402

from lbm_ferrofluid_tpu_torch.models import (  # noqa: E402
    ferrofluid_step,
    prime_premac,
    rosensweig_2d,
    rosensweig_3d,
    rosensweig_3d_tpu,
)
from lbm_ferrofluid_tpu_torch.ops.kernels import _lib  # noqa: E402
from lbm_ferrofluid_tpu_torch.parallel import (  # noqa: E402
    Mesh,
    auto_mesh_shape,
    gather_state,
    initialize_distributed,
    make_mesh,
    shard_state,
)
from lbm_ferrofluid_tpu_torch.parallel import step3d  # noqa: E402

import lbm_ferrofluid_tpu_torch.models.ferrofluid as port_ferro  # noqa: E402

STEPS = 3
FIELDS = ("f", "g", "vel", "density", "pressure")
CPU = torch.device("cpu")
OBSTACLE = worker.OBSTACLE


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_steps():
    """3 JAX single-device steps of the flagship scene, by sweeps a solve
    (tests/test_sharded_step.py's reference: jnp, the channel-form solve),
    and with the field along z (route O's scene) at 3 sweeps."""
    out = {}
    for key, iters, axis in ((3, 3, 1), (6, 6, 1), ("O", 3, 2)):
        params = JParams(poisson_iters=iters, **worker.FLAGSHIP, h_ext_axis=axis).replace(
            use_pallas=False)
        s = jinit(params, *worker.flagship_fields())
        for _ in range(STEPS):
            s = jstep(params, s)
        out[key] = s
    return out


def port_steps(iters, route="Z"):
    params, s = worker.port_state(iters, route=route)
    s = worker.on_route(prime_premac(params, s, device="cpu"), route)
    for _ in range(STEPS):
        s = ferrofluid_step(params, s, device="cpu")
    return s


def assert_matches_jax(got, want, batch_index=None, fields=FIELDS):
    for name in fields:
        a = got[name] if batch_index is None else got[name][batch_index:batch_index + 1]
        np.testing.assert_allclose(a, np.asarray(getattr(want, name)), rtol=2e-5, atol=1e-6,
                                   err_msg=name)
    h = got["h"] if batch_index is None else got["h"][batch_index:batch_index + 1]
    a, b = compare_views(jnp.asarray(h), want.h, want.magnetic_flags)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=2e-5, atol=1e-6,
                               err_msg="h (collapse contract)")


@pytest.mark.parametrize("nz,iters", [(2, 3), (4, 6)], ids=["nz2", "nz4"])
def test_sharded_steady_state_matches(nz, iters, jax_steps, tmp_path):
    """Prime and 3 steps on nz gloo ranks: against JAX's single-device
    steps at tests/test_sharded_step.py's bars, and bit for bit against the
    port's single-device steps; with 2 ranks, the checkpoint resume."""
    got = worker.run_ranks(nz, tmp_path, shape=(1, nz), slab=False, poisson_iters=iters,
                           batch=1, steps=STEPS, checkpoint=nz == 2)
    assert got["h"].shape[1] == 2 and all(f"premac.{i}" in got for i in range(6))
    assert "phi" not in got and "force" not in got
    assert_matches_jax(got, jax_steps[iters])
    ref = port_steps(iters)
    want = worker.named_fields(ref, FIELDS + ("h", "rho"))
    with worker.keep_mismatch(tmp_path, f"Z nz{nz}", got, want):
        for name in FIELDS + ("h", "rho"):
            np.testing.assert_array_equal(got[name], getattr(ref, name).numpy(), err_msg=name)
        for i, leaf in enumerate(ref.premac):
            np.testing.assert_array_equal(got[f"premac.{i}"], leaf.numpy(),
                                          err_msg=f"premac {i}")
    if nz == 2:
        resumed = dict(np.load(tmp_path / "resumed.npz"))
        assert resumed.keys() == got.keys()
        with worker.keep_mismatch(tmp_path, f"Z nz{nz} resumed", resumed, got):
            for name in got:
                np.testing.assert_array_equal(resumed[name], got[name], err_msg=name)


#: the fields the epilogue routes also return (the JAX step's force and phi)
EPI_FIELDS = FIELDS + ("force", "phi")


@pytest.mark.parametrize("route,nz,iters", [("E", 2, 3), ("O", 2, 3), ("U", 2, 3),
                                            ("E", 4, 6)],
                         ids=["E-nz2", "O-nz2", "U-nz2", "E-nz4"])
def test_meshed_epilogue_routes_match(route, nz, iters, jax_steps, tmp_path):
    """Routes E, O and U (B10b, B6 and B5 in slab form; B4 each step on U):
    prime and 3 steps on nz gloo ranks against JAX's single-device steps of
    the same scene at the bars above (force and phi too), and bit for bit
    against the port's single-device steps of the same route: every cell's
    arithmetic is the same in the plain versions (on the card B6's
    single-device kernel builds the Laplacian from its own density map,
    the slab route feeds it B10b's: see chip_smoke.py's sharded phase);
    E on 2 ranks with the checkpoint resume."""
    got = worker.run_ranks(nz, tmp_path, shape=(1, nz), slab=False, poisson_iters=iters,
                           batch=1, steps=STEPS, checkpoint=route == "E" and nz == 2,
                           route=route)
    n_premac = {"E": 5, "O": 5, "U": 0}[route]
    assert got["h"].shape[1] == 2 and {k for k in got if k.startswith("premac.")} == {
        f"premac.{i}" for i in range(n_premac)}
    assert_matches_jax(got, jax_steps["O" if route == "O" else iters], fields=EPI_FIELDS)
    ref = port_steps(iters, route)
    want = worker.named_fields(ref, EPI_FIELDS + ("h", "rho"))
    with worker.keep_mismatch(tmp_path, f"{route} nz{nz}", got, want):
        for name in EPI_FIELDS + ("h", "rho"):
            np.testing.assert_array_equal(got[name], getattr(ref, name).numpy(), err_msg=name)
        for i, leaf in enumerate(ref.premac or ()):
            np.testing.assert_array_equal(got[f"premac.{i}"], leaf.numpy(),
                                          err_msg=f"premac {i}")
    if route == "E" and nz == 2:
        resumed = dict(np.load(tmp_path / "resumed.npz"))
        assert resumed.keys() == got.keys()
        with worker.keep_mismatch(tmp_path, f"{route} nz{nz} resumed", resumed, got):
            for name in got:
                np.testing.assert_array_equal(resumed[name], got[name], err_msg=name)


@pytest.mark.parametrize("route", ["E", "O", "U"])
def test_slab_forced_epilogue_routes_match(route, tmp_path):
    """One rank with ``slab=True`` on routes E, O and U: every slab form,
    its ghosts the rank's own wrap and both z edges true, bit for bit to
    the single-device steps of the same route."""
    mesh = make_mesh(device="cpu", slab=True)
    params, s = worker.port_state(3, route=route)
    s = worker.on_route(prime_premac(params, shard_state(s, mesh), mesh=mesh), route)
    for _ in range(STEPS):
        s = ferrofluid_step(params, s, mesh=mesh)
    ref = port_steps(3, route)
    names = EPI_FIELDS + ("h", "rho")
    with worker.keep_mismatch(tmp_path, f"{route} slab", worker.named_fields(s, names),
                              worker.named_fields(ref, names)):
        for name in EPI_FIELDS + ("h", "rho"):
            assert torch.equal(getattr(s, name), getattr(ref, name)), name
    assert (s.premac is None) == (route == "U")


@pytest.mark.parametrize("Z", [12, 8], ids=["3-plane", "2-plane"])
def test_step_gates_match_priming(Z):
    """ROADMAP C7: on 4 z ranks of 3- or 2-plane slabs a 3D state takes the
    block route, whose priming only converts h and leaves no premac
    (tests/test_torch_mesh3d.py primes and steps it there).  A state primed
    on one device and cut onto those slabs refuses at the step on routes Z
    and E with the message that priming it gives, which names the block
    route and says to prime on the mesh; on route U (premac None, the carry
    as the block route's priming makes it) it passes the step's gates."""
    params, s = rosensweig_3d(res=(Z, 8, 10), device="cpu")
    primed = prime_premac(params, s, device="cpu")
    for iz in range(4):
        mesh = _mesh((1, 4), iz=iz)
        assert not step3d.on_slabs(mesh, shard_state(s, mesh).f.shape)
        with pytest.raises(ValueError, match="premac on the block route") as at_prime:
            prime_premac(params, shard_state(primed, mesh), mesh=mesh)
        assert "prime the state on the mesh" in str(at_prime.value)
        for route in ("Z", "E", "U"):
            part = worker.on_route(shard_state(primed, mesh), route)
            if route == "U":
                assert port_ferro._block_gates(part, mesh, False).block == (Z // 4, 8, 10)
                continue
            with pytest.raises(ValueError, match="premac on the block route") as at_step:
                ferrofluid_step(params, part, mesh=mesh)
            assert str(at_step.value) == str(at_prime.value)


def test_batch_mesh_matches(jax_steps, tmp_path):
    """A (batch 2, z 1) mesh of a batch-2 state on 2 ranks: each rank steps
    its element on the single-device kernels (the data-parallel dispatch),
    each against JAX's single-device steps."""
    got = worker.run_ranks(2, tmp_path, shape=(2, 1), slab=False, poisson_iters=3, batch=2,
                           steps=STEPS)
    assert got["f"].shape[0] == 2 and got["h"].shape[1] == 2
    for b in range(2):
        assert_matches_jax(got, jax_steps[3], batch_index=b)


def test_slab_forced_one_rank_matches(jax_steps, tmp_path):
    """One rank with ``slab=True``: the slab forms, ghosts from the rank's
    own wrap, bit for bit to the single-device steps and at the bars to
    JAX's."""
    from lbm_ferrofluid_tpu_torch.models.state import to_numpy

    mesh = make_mesh(device="cpu", slab=True)
    assert (mesh.nz, mesh.slab, step3d.dp_dispatch(mesh)) == (1, True, False)
    params, s = worker.port_state(3)
    s = prime_premac(params, shard_state(s, mesh), mesh=mesh)
    for _ in range(STEPS):
        s = ferrofluid_step(params, s, mesh=mesh)
    ref = port_steps(3)
    names = FIELDS + ("h", "rho")
    with worker.keep_mismatch(tmp_path, "Z slab", worker.named_fields(s, names),
                              worker.named_fields(ref, names)):
        for name in FIELDS + ("h", "rho"):
            assert torch.equal(getattr(s, name), getattr(ref, name)), name
    assert_matches_jax(to_numpy(s), jax_steps[3])


def _jax_channel_sweeps(h, flags, rhs_scaled, tau, n_iters):
    """The JAX package's single-device channel-form Poisson loop
    (tests/test_halo.py's reference): stream, bounce back, collide."""
    from lbm_ferrofluid_tpu import D3Q19 as JD3Q19
    from lbm_ferrofluid_tpu.ops import bounce_back, heq, stream

    w = jnp.asarray(JD3Q19.w_bcast(np.float64), dtype=h.dtype)
    w0 = float(JD3Q19.weights[0])
    add_h = w * rhs_scaled
    is_obs = flags == OBSTACLE
    psi = jnp.zeros_like(rhs_scaled)
    for _ in range(n_iters):
        h = bounce_back(JD3Q19, stream(JD3Q19, h), flags)
        psi = jnp.sum(h[:, 1:], axis=1, keepdims=True) / (1.0 - w0)
        h = jnp.where(is_obs, h, (1.0 - 1.0 / tau) * h + heq(JD3Q19, psi) / tau + add_h)
    return h, psi


def test_sharded_poisson_sweeps_matches_jax(tmp_path):
    """``halo.sharded_poisson_sweeps`` on 2 gloo z ranks (one plane of the
    z-moving channels exchanged a side a sweep) against the JAX package's
    single-device channel-form loop on the same inputs, at
    tests/test_halo.py's bars."""
    Z, Y, X = 16, 8, 16
    rng = np.random.default_rng(7)
    h = rng.uniform(0.0, 1.0, (1, 19, Z, Y, X)).astype(np.float32)
    flags = np.full((1, 1, Z, Y, X), OBSTACLE, np.uint8)
    flags[..., 1:-1, :, 1:-1] = worker.FLUID
    rhs = rng.uniform(-1e-3, 1e-3, (1, 1, Z, Y, X)).astype(np.float32)
    got_h, got_psi = worker.run_sweeps(2, tmp_path, h, flags, rhs, tau=0.8, n_iters=6)
    want_h, want_psi = _jax_channel_sweeps(jnp.asarray(h), jnp.asarray(flags), jnp.asarray(rhs),
                                           0.8, 6)
    np.testing.assert_allclose(got_h, np.asarray(want_h), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got_psi, np.asarray(want_psi), rtol=1e-5, atol=1e-6)


def _mesh(shape, iz=0, slab=False):
    """This rank's mesh of ``shape`` (batch, z) at z index ``iz``, without a
    process group: for the gates, which exchange nothing."""
    return Mesh(("batch", "z"), shape, iz, CPU, "gloo" if shape[1] > 1 else None, slab)


def test_shard_and_gather_one_rank():
    params, s = rosensweig_3d(res=(8, 8, 10), device="cpu")
    mesh = make_mesh(device="cpu")
    assert torch.equal(shard_state(s, mesh).f, s.f)
    assert gather_state(s, mesh) is s
    part = shard_state(s, _mesh((1, 2), iz=1))
    assert torch.equal(part.f, s.f[:, :, 4:])
    # H_ext_mac's z-staggered leaf (Z + 1 planes) stays whole
    assert [t.shape[2] for t in part.H_ext_mac] == [4, 4, 9]


def test_gates_and_refusals():
    params, s = rosensweig_3d(res=(16, 8, 10), device="cpu")
    with pytest.raises(ValueError, match="does not split over the mesh's z axis"):
        shard_state(s, _mesh((1, 3)))
    # 2-plane slabs and a mesh of z with y take the block route
    thin = _mesh((1, 8))
    assert not step3d.on_slabs(thin, shard_state(s, thin).f.shape)
    assert step3d.on_slabs(_mesh((1, 4)), shard_state(s, _mesh((1, 4))).f.shape)
    assert make_mesh(("z", "y"), (1, 1), device="cpu").sizes == {"z": 1, "y": 1}
    assert not step3d.sharded3d_ok(Mesh(("z", "y"), (1, 2), 0, CPU), (1, 19, 16, 8, 10))
    assert not step3d.sharded3d_ok(_mesh((1, 3)), (1, 19, 16, 8, 10))
    assert step3d.fused_step_sharded_ok(_mesh((1, 4)), (1, 19, 16, 8, 10), None)
    assert not step3d.fused_step_sharded_ok(_mesh((1, 8)), (1, 19, 16, 8, 10), None)
    assert step3d.scalar_slab_plan(_mesh((1, 2)), (1, 2, 256, 8, 8), 30) == (30, 31)
    assert step3d.scalar_slab_plan(_mesh((1, 2)), (1, 2, 256, 256, 256), 30) == (15, 16)
    assert step3d.scalar_slab_plan(_mesh((1, 1), slab=True), (1, 2, 130, 66, 130), 30) == (30, 31)
    assert step3d.scalar_slab_plan(_mesh((1, 2)), (1, 2, 130, 66, 130), 30) == (30, 31)
    assert step3d.scalar_slab_plan(_mesh((1, 4)), (1, 2, 16, 8, 8), 30) == (3, 4)
    assert step3d.scalar_slab_plan(_mesh((1, 8)), (1, 2, 16, 8, 8), 30) is None


def _routes():
    """Each route the slab mesh does not run, as a call that must raise."""
    slab = make_mesh(device="cpu", slab=True)

    def primed(p, s):
        return prime_premac(p, shard_state(s, slab), mesh=slab)

    def padded():
        primed(*rosensweig_3d_tpu(res=(6, 8, 10), batch=2, device="cpu"))

    def two_d():
        p, s = rosensweig_2d(res=(16, 16), device="cpu")
        ferrofluid_step(p, s, mesh=slab)

    return {"padded": (padded, "a batch keeps the 19-channel h"),
            "2d": (two_d, "2D states split along y and x")}


@pytest.mark.parametrize("route", sorted(_routes()))
def test_unported_meshed_routes_raise(route):
    """Each route left raises: a padded batch, as the JAX package refuses it
    (a padded layout of one element steps on slabs,
    tests/test_torch_mesh3d_padded.py), a 2D state saying that 2D states
    split along y and x (tests/test_torch_mesh2d.py); the channel form, an
    un-primed 19-channel h and the HCZ step run on slabs
    (tests/test_torch_parallel_channel.py)."""
    call, message = _routes()[route]
    with pytest.raises(NotImplementedError, match=message):
        call()


def test_auto_mesh_shape_matches_jax():
    for n, axes in ((8, 2), (8, 3), (1, 2), (6, 2), (12, 2), (7, 2), (16, 3)):
        assert auto_mesh_shape(n, axes) == jauto(n, axes)


def test_initialize_distributed_without_torchrun(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert initialize_distributed() == 1
    assert not torch.distributed.is_initialized()
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="coordinator"):
        initialize_distributed()


def test_launch_on_the_tensors_card(monkeypatch):
    """A kernel launches on the current card, so ``stream_of`` (every
    wrapper's stream) refuses a tensor on another card: with card 0
    current, a tensor on card 3 raises and one on card 0 gets its stream."""
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=7))
    with pytest.raises(RuntimeError, match=r"current card \(cuda:0\).*cuda:3"):
        _lib.stream_of(types.SimpleNamespace(device=torch.device("cuda", 3)))
    for dev in (torch.device("cuda", 0), torch.device("cuda")):
        assert _lib.stream_of(types.SimpleNamespace(device=dev)).value == 7


def test_worker_imports_no_jax():
    tree = ast.parse(pathlib.Path(worker.__file__).read_text())
    mods = {n.module or "" for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
    mods |= {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    assert not {m.split(".")[0] for m in mods} & {"jax", "jaxlib", "lbm_ferrofluid_tpu"}
