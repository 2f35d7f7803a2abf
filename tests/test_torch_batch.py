"""Batched states on one device: every model of the port steps [B, ...].

* the port at B = 2 against the JAX package at B = 2, 3 steps through the
  normal entry points, at the float32 contract (rel <= 5e-5 a field, vel
  also abs <= 5e-6; docs/PARITY.md:78-93): the 3D ferrofluid (un-carried
  on the 19-channel h, as ``prime_premac`` leaves a batch in both
  packages), 3D HCZ, 3D single phase, and 2D ferrofluid, HCZ, Shan-Chen,
  KBC and BGK;
* each element of the port's B = 2 step equals the port's B = 1 step of
  that element bit for bit, and a perturbed element leaves the others'
  bits unchanged;
* ``prime_premac`` at B = 2 is a no-op in 2D and 3D (premac None, h in 19
  or 9 channels), as in JAX;
* each of the nine kernels on the batched routes (B2, B4, B5, B6, B8a,
  B8b, B9, B10a, B11b with B7's trailing stage): its plain version at B = 2
  equals two B = 1 calls bit for bit (the wrappers take it on CPU tensors);
* the raises: a padded layout at B > 1 (as the JAX package's own step
  refuses it), the scalar carry or the 6-leaf premac at B > 1 (slice 8);
* a ``slab=True`` mesh with two elements a rank steps on the block route,
  bit for bit to one device's batched steps;
* a (batch 2, z 1) mesh of gloo ranks with B = 4 (two elements a rank)
  equals one device's B = 4 steps bit for bit; checkpoint save and load of
  a B = 4 state, the runner's NaN guard on one bad element and the
  diagnostics' sums over the elements.

Every element differs: each is moved by noise from its own numpy seed (the
scene builders' ``batch=`` copies one element, which would hide mixing).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lbm_ferrofluid_tpu import models as jmodels  # noqa: E402
from lbm_ferrofluid_tpu.models import scenes as jscenes  # noqa: E402

import torch_mesh_worker as worker  # noqa: E402
from lbm_ferrofluid_tpu_torch import models as pm  # noqa: E402
from lbm_ferrofluid_tpu_torch.ops.kernels import capmac, contact3d, fused_step, hcz3d  # noqa: E402
from lbm_ferrofluid_tpu_torch.ops.kernels import poisson, stencil3d, stream3d  # noqa: E402
from lbm_ferrofluid_tpu_torch.parallel import make_mesh, shard_state  # noqa: E402
from lbm_ferrofluid_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint  # noqa: E402
from lbm_ferrofluid_tpu_torch.utils.diagnostics import diagnostics  # noqa: E402

OBSTACLE, FLUID = 2, 1
B = 2


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _fields(state):
    """A state (JAX or port) as numpy arrays by field name; None and tuples
    kept, ``step`` an int."""
    def conv(v):
        if v is None or isinstance(v, int):
            return v
        if isinstance(v, tuple):
            return tuple(conv(x) for x in v)
        return v.numpy() if torch.is_tensor(v) else np.asarray(v)
    return {f.name: conv(getattr(state, f.name)) for f in dataclasses.fields(state)}


def _distinct(fields, batch=B, seed=3):
    """``fields`` at ``batch`` elements (a batch of one tiled) whose f, g and
    h are each moved by noise from the element's own seed: f and g by a
    relative 1e-3, h by 1e-4 (it starts at zero)."""
    out = {}
    for k, v in fields.items():
        if isinstance(v, np.ndarray) and v.ndim >= 3 and v.shape[0] == 1 and batch > 1:
            v = np.repeat(v, batch, axis=0)
        elif isinstance(v, tuple):
            v = tuple(np.repeat(x, batch, axis=0) if x.shape[0] == 1 and batch > 1 else x
                      for x in v)
        out[k] = v
    for name, scale, relative in (("f", 1e-3, True), ("g", 1e-3, True), ("h", 1e-4, False)):
        x = out.get(name)
        if x is None:
            continue
        x = x.copy()
        for b in range(batch):
            n = np.random.default_rng(seed + 101 * b).uniform(-1, 1, x[b].shape)
            x[b] = (x[b] * (1 + scale * n) if relative else x[b] + scale * n).astype(x.dtype)
        out[name] = x
    return out


def _to_jax(jstate, fields):
    def conv(v):
        if isinstance(v, tuple):
            return tuple(conv(x) for x in v)
        return jnp.asarray(v) if isinstance(v, np.ndarray) else v
    return dataclasses.replace(jstate, **{k: conv(v) for k, v in fields.items()
                                          if k != "step" and v is not None})


def _element(state, b):
    """Element ``b`` of a port state as a batch of one."""
    def part(v):
        if torch.is_tensor(v):
            return v[b:b + 1]
        if isinstance(v, tuple):
            return tuple(part(x) for x in v)
        return v
    return dataclasses.replace(state, **{f.name: part(getattr(state, f.name))
                                         for f in dataclasses.fields(state)})


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _taylor_green_3d(res=(8, 10, 12), batch=1):
    """A 3D single-phase BGK state's arrays: a walled box with a small
    Taylor-Green velocity."""
    Z, Y, X = res
    z, y, x = np.meshgrid(*(np.arange(n) * 2 * np.pi / n for n in res), indexing="ij")
    vel = np.zeros((batch, 3, *res), np.float32)
    vel[:, 0] = 0.04 * np.sin(x) * np.cos(y)
    vel[:, 1] = -0.04 * np.cos(x) * np.sin(y)
    flags = np.full((batch, 1, *res), FLUID, np.uint8)
    flags[..., 0, :, :] = flags[..., -1, :, :] = OBSTACLE
    vel[:, :, flags[0, 0] == OBSTACLE] = 0.0
    return np.ones((batch, 1, *res), np.float32), vel, flags


def _single3d():
    jp = jmodels.SimulationParams(dim=3, tau=0.8)
    return jp, jmodels.init_singlephase_state(jp, *_taylor_green_3d())


#: model: (JAX (params, state) at B = 1 or 2, JAX step, port step, fields
#: compared, params changes)
MODELS = {
    "ferro3d": (lambda: jscenes.rosensweig_3d(res=(16, 8, 16), batch=B),
                jmodels.ferrofluid_step, pm.ferrofluid_step,
                ("f", "g", "h", "rho", "vel", "density", "pressure"), dict(poisson_iters=3)),
    "hcz3d": (lambda: jscenes.multiphase_3d(res=(8, 8, 10), batch=B), jmodels.hcz_step,
              pm.hcz_step, ("f", "g", "rho", "vel", "density", "pressure"), {}),
    "single3d": (_single3d, jmodels.singlephase_step, pm.singlephase_step,
                 ("f", "rho", "vel"), {}),
    "ferro2d": (lambda: jscenes.rosensweig_2d(res=(20, 24), batch=B), jmodels.ferrofluid_step,
                pm.ferrofluid_step, ("f", "g", "h", "rho", "vel", "density", "pressure"),
                dict(poisson_iters=5)),
    "hcz2d": (lambda: jscenes.multiphase_drop_hcz(res=(16, 20), batch=B), jmodels.hcz_step,
              pm.hcz_step, ("f", "g", "rho", "vel", "density", "pressure"), {}),
    "sc2d": (lambda: jscenes.multiphase_drop_sc(res=(16, 20), batch=B), jmodels.sc_step,
             pm.sc_step, ("f", "rho", "vel", "density"), {}),
    "kbc2d": (lambda: jscenes.shear_layer(res=(16, 20), kbc=True, batch=B),
              jmodels.singlephase_step, pm.singlephase_step, ("f", "rho", "vel"), {}),
    "bgk2d": (lambda: jscenes.shear_layer(res=(16, 20), batch=B), jmodels.singlephase_step,
              pm.singlephase_step, ("f", "rho", "vel"), {}),
}


def _model(name):
    """(JAX params, JAX state, port params, port state, port step) of a
    model at B = 2 distinct elements, each ferrofluid state primed in its
    own package (a no-op at B > 1)."""
    build, _, step, _, change = MODELS[name]
    jp, js = build()
    jp = jp.replace(**change)
    fields = _distinct(_fields(js))
    js = _to_jax(js, fields)
    pp = pm.SimulationParams.from_json(jp.to_json())
    ps = pm.from_numpy(fields, device="cpu")
    if step is pm.ferrofluid_step:
        jp = jp.replace(use_pallas=False)
        js = jmodels.prime_premac(jp, js)
        ps = pm.prime_premac(pp, ps, device="cpu")
    return jp, js, pp, ps, step


@pytest.mark.parametrize("name", sorted(MODELS))
def test_batch_of_two_matches_jax(name):
    """3 steps of a B = 2 state of distinct elements, port against JAX."""
    jp, js, pp, ps, step = _model(name)
    jstep, names = MODELS[name][1], MODELS[name][3]
    for _ in range(3):
        js = jstep(jp, js)
        ps = step(pp, ps, device="cpu")
    assert ps.step == int(js.step) == 3 and ps.f.shape[0] == B
    for fld in names:
        got, want = getattr(ps, fld).numpy(), np.asarray(getattr(js, fld))
        assert got.shape == want.shape, fld
        r = rel(got, want)
        ok = r <= 5e-5 or (fld == "vel" and np.abs(got - want).max() <= 5e-6)
        assert ok, f"{name} {fld}: rel {r:.2e}, abs {np.abs(got - want).max():.2e}"


@pytest.mark.parametrize("name", sorted(MODELS))
def test_each_element_steps_as_alone_and_apart(name):
    """Each element of a B = 2 step equals its own B = 1 step bit for bit;
    moving element 1 leaves element 0's bits unchanged."""
    _, _, pp, ps, step = _model(name)
    out = step(pp, ps, device="cpu")
    for b in range(B):
        alone = step(pp, _element(ps, b), device="cpu")
        for fld in MODELS[name][3]:
            assert torch.equal(getattr(out, fld)[b:b + 1], getattr(alone, fld)), (name, b, fld)
    moved = ps.replace(f=ps.f.clone())
    moved.f[1] *= 1.01
    out2 = step(pp, moved, device="cpu")
    for fld in MODELS[name][3]:
        assert torch.equal(getattr(out2, fld)[0], getattr(out, fld)[0]), (name, fld)
    assert not torch.equal(out2.f[1], out.f[1])


@pytest.mark.parametrize("dim", [2, 3])
def test_prime_premac_leaves_a_batch_as_jax(dim):
    jbuild = jscenes.rosensweig_2d if dim == 2 else jscenes.rosensweig_3d
    res = (20, 24) if dim == 2 else (16, 8, 16)
    jp, js = jbuild(res=res, batch=B)
    pp = pm.SimulationParams.from_json(jp.to_json())
    ps = pm.from_numpy(_fields(js), device="cpu")
    jprimed = jmodels.prime_premac(jp, js)
    primed = pm.prime_premac(pp, ps, device="cpu")
    assert primed.premac is None and jprimed.premac is None
    assert primed.h.shape[1] == np.asarray(jprimed.h).shape[1] == (9 if dim == 2 else 19)
    assert primed.cmask is None and jprimed.cmask is None
    # a single element still primes to the scalar carry
    one = pm.prime_premac(pp, _element(ps, 0), device="cpu")
    assert one.h.shape[1] == 2


def _rng_fields(seed, shape, lo=0.0, hi=1.0):
    return torch.from_numpy(np.random.default_rng(seed).uniform(lo, hi, shape)
                            .astype(np.float32))


def _kernel_inputs(res=(6, 8, 10), batch=B, seed=11):
    """Per-element random inputs of the nine kernels (distinct elements)."""
    Z, Y, X = res
    rng = np.random.default_rng(seed)
    flags = np.full((batch, 1, *res), FLUID, np.uint8)
    flags[..., 0, :, :] = flags[..., -1, :, :] = OBSTACLE
    flags[..., :, 0, :] = flags[..., :, :, -1] = OBSTACLE
    for b in range(batch):  # an obstacle block that differs an element
        flags[b, 0, 2:4, 2 + b:5 + b, 3:5] = OBSTACLE
    mf = np.full((batch, 1, *res), FLUID, np.uint8)
    mf[..., 0, :, :] = mf[..., -1, :, :] = mf[..., :, :, 0] = mf[..., :, :, -1] = OBSTACLE
    f = rng.uniform(0.01, 0.05, (batch, 19, *res)).astype(np.float32)
    g = rng.uniform(0.01, 0.05, (batch, 19, *res)).astype(np.float32)
    h = rng.uniform(-0.1, 0.1, (batch, 19, *res)).astype(np.float32)
    rho = rng.uniform(0.02, 0.26, (batch, 1, *res)).astype(np.float32)
    t = torch.from_numpy
    return dict(
        f=t(f), g=t(g), h=t(h), flags=t(flags), mflags=t(mf), rho=t(rho),
        rho_ca=t(rho * 1.01), density=t(rho * 0.9), pressure=t(rho * 0.33),
        vel=_rng_fields(seed + 1, (batch, 3, *res), -0.01, 0.01),
        force=_rng_fields(seed + 2, (batch, 3, *res), -1e-4, 1e-4),
        dfai=_rng_fields(seed + 3, (batch, 3, *res), -1e-4, 1e-4),
        dprho=_rng_fields(seed + 4, (batch, 3, *res), -1e-4, 1e-4),
        m0g=_rng_fields(seed + 5, (batch, 1, *res), 0.0, 0.1),
        m1g=_rng_fields(seed + 6, (batch, 3, *res), -1e-3, 1e-3),
        H2=_rng_fields(seed + 7, (batch, 1, *res), 0.0, 1e4),
        phi=_rng_fields(seed + 8, (batch, 1, *res), -1.0, 1.0),
        rhs=_rng_fields(seed + 9, (batch, 1, *res), -1e-3, 1e-3),
    )


GAS = dict(rho_gas=0.02381, rho_fluid=0.2508, density_gas=0.02381, density_fluid=0.2508)
HCZ_K = dict(tau_f=0.68, tau_g=0.68, dx=1.0, dt=1.0)
CAP_K = dict(kappa=0.01, gravity=(0.0, -1e-4, 0.0), dx=1.0, dt=1.0, **GAS)

#: kernel: a call of its plain version on the inputs of :func:`_kernel_inputs`
KERNEL_CALLS = {
    "B2": lambda a: contact3d.contact_angle_3d_plain(a["rho"], a["flags"], 1.2),
    "B4": lambda a: fused_step.lbm_prologue_plain(a["f"], a["g"], a["flags"], a["rho"],
                                                  a["vel"], c=1.0, **GAS),
    "B5": lambda a: fused_step.lbm_epilogue_plain(
        a["f"], a["g"], a["flags"], a["rho"], a["vel"], a["density"], a["pressure"],
        a["force"], a["dfai"], a["dprho"], **HCZ_K),
    "B5 emit_mac": lambda a: fused_step.lbm_epilogue_plain(
        a["f"], a["g"], a["flags"], a["rho"], a["vel"], a["density"], a["pressure"],
        a["force"], a["dfai"], a["dprho"], emit_mac=True, mac_consts=(1.0, *GAS.values()),
        **HCZ_K),
    "B6": lambda a: capmac.hcz_capillary_gradmac_plain(
        a["rho"], a["density"], a["pressure"], a["rho_ca"], None, None, a["flags"], a["m0g"],
        a["m1g"], a["vel"], **CAP_K),
    "B6 H2": lambda a: capmac.hcz_capillary_gradmac_plain(
        a["rho"], a["density"], a["pressure"], a["rho_ca"], a["H2"], a["phi"], a["flags"],
        a["m0g"], a["m1g"], a["vel"], **CAP_K),
    "B8a": lambda a: stream3d.stream_bounce_moments_plain(a["f"], a["flags"]),
    "B8b": lambda a: stream3d.stream_bounce_macro_plain(a["f"], a["flags"], a["rho"],
                                                        a["vel"], c=1.0, **GAS),
    "B9": lambda a: hcz3d.hcz_collide_fused_plain(
        a["f"], a["g"], a["rho"], a["vel"], a["density"], a["pressure"], a["flags"],
        a["force"], a["dfai"], a["dprho"], **HCZ_K),
    "B10a": lambda a: stencil3d.grad_fields_plain(a["phi"]),
    "B10a N=3": lambda a: stencil3d.grad_fields_plain(torch.cat([a["phi"], a["rho"],
                                                                 a["H2"]], dim=1)),
    "B10a slab": lambda a: stencil3d.grad_fields_plain(
        a["phi"][:, :, 1:-1], (a["phi"][:, :, :1], a["phi"][:, :, -1:]), (-1, 4)),
    "B11b": lambda a: poisson.poisson_sweeps_plain(a["h"], a["mflags"], a["rhs"], tau=0.8,
                                                   n_iters=3),
    "B11b B7 h2": lambda a: poisson.poisson_sweeps_plain(
        a["h"], a["mflags"], a["rhs"], tau=1.0, n_iters=3, emit="h2", h_ext=(0.0, 85.0, 0.0)),
    "B11b B7 hint": lambda a: poisson.poisson_sweeps_plain(a["h"], a["mflags"], a["rhs"],
                                                           tau=0.8, n_iters=3, emit="hint"),
}


def _flat(out):
    if torch.is_tensor(out):
        return [out]
    return [t for x in out for t in _flat(x)]


@pytest.mark.parametrize("kid", sorted(KERNEL_CALLS))
def test_kernel_plain_version_at_b2_equals_two_b1_calls(kid):
    a = _kernel_inputs()
    both = _flat(KERNEL_CALLS[kid](a))
    for b in range(B):
        alone = _flat(KERNEL_CALLS[kid]({k: v[b:b + 1] for k, v in a.items()}))
        assert len(alone) == len(both)
        for i, (x, y) in enumerate(zip(both, alone)):
            assert x.shape[0] == B and torch.equal(x[b:b + 1], y), (kid, b, i)


def test_batch_instances_are_the_cuda_sources():
    """``BATCH_EXT_HEIGHTS`` is csrc/poisson.cu's PP_BATCH_HEIGHTS, and every
    pass of ``plan`` is among them (a batch launches those instances)."""
    import pathlib
    import re

    src = (pathlib.Path(poisson.__file__).parents[2] / "csrc" / "poisson.cu").read_text()
    line = re.search(r"#define PP_BATCH_HEIGHTS\(M\) (.*)", src)[1]
    assert tuple(int(e) for e in re.findall(r"M\((\d+)\)", line)) == poisson.BATCH_EXT_HEIGHTS
    for n in (1, 2, 3, 7, 30):
        pl = poisson.plan(256, 256, 256, n, 132)
        assert all(pl.ty + 2 * (k - 1) in poisson.BATCH_EXT_HEIGHTS for k in pl.passes), n
    # the block route's rounds (any k up to the sweeps, psi emitted by the
    # last pass) on a block's extended shapes launch the same instances
    for n in range(1, 31):
        for shape in ((11, 19, 71), (69, 39, 71), (37, 35, 33)):
            pl = poisson.plan(*shape, n, 132)
            assert all(pl.ty + 2 * (k - 1) in poisson.BATCH_EXT_HEIGHTS for k in pl.passes), n


def test_kernel_costs_count_every_element():
    """``cost`` of a B = 2 call is the sum of its elements' (bytes and
    flops scale by B for equal elements)."""
    a = _kernel_inputs()
    one = {k: v[:1] for k, v in a.items()}
    two = {k: torch.cat([v[:1], v[:1]]) for k, v in a.items()}
    for cost, args, kw in (
            (contact3d.cost, ("rho", "flags"), {}),
            (fused_step.cost, ("f", "g", "flags", "rho", "vel"), {}),
            (stream3d.cost_moments, ("f", "flags"), {}),
            (hcz3d.cost, ("f", "g", "rho", "vel", "density", "pressure", "flags", "force",
                          "dfai", "dprho"), {}),
            (capmac.cost, ("rho", "density", "pressure", "rho_ca", "H2", "phi", "flags",
                           "m0g", "m1g", "vel"), {}),
            (stencil3d.cost, ("phi",), {}),
            (poisson.cost, ("h", "mflags", "rhs"), dict(tau=1.0, n_iters=30, emit="h2",
                                                        h_ext=(0.0, 85.0, 0.0)))):
        c1 = cost(*(one[k] for k in args), **kw)
        c2 = cost(*(two[k] for k in args), **kw)
        assert c2 == (2 * c1[0], 2 * c1[1]), cost.__module__


def test_padded_layout_at_b2_raises():
    """A padded layout at B = 2 is refused as the JAX package refuses it: a
    batch keeps the 19-channel h, and the channel-form solve does not take
    ``phys_extent`` (JAX's ``ferrofluid_step`` raises after its own
    ``prime_premac``, which leaves the batch as it is)."""
    params, state = pm.rosensweig_3d_tpu(res=(6, 8, 10), device="cpu")
    two = dataclasses.replace(state, **{
        f.name: (torch.cat([v, v]) if torch.is_tensor(v) else
                 tuple(torch.cat([x, x]) for x in v) if isinstance(v, tuple) else v)
        for f in dataclasses.fields(state) for v in (getattr(state, f.name),)})
    refusal = "a batch keeps the 19-channel h .* does not take phys_extent"
    with pytest.raises(NotImplementedError, match=refusal):
        pm.prime_premac(params, two, device="cpu")
    with pytest.raises(NotImplementedError, match=refusal):
        pm.ferrofluid_step(params, two, device="cpu")
    jp, js = jscenes.rosensweig_3d_tpu(res=(6, 8, 10))
    js = dataclasses.replace(js, **{
        f.name: (jnp.concatenate([v, v]) if isinstance(v, jnp.ndarray) and v.ndim else
                 tuple(jnp.concatenate([x, x]) for x in v) if isinstance(v, tuple) else v)
        for f in dataclasses.fields(js) for v in (getattr(js, f.name),)})
    js = jmodels.prime_premac(jp, js)
    assert js.premac is None and js.h.shape[:2] == (2, 19)
    with pytest.raises(NotImplementedError, match="require the tau==1 scalar Poisson carry"):
        jmodels.ferrofluid_step(jp, js)


def test_slab_mesh_with_two_elements_a_rank_steps_bit_for_bit(monkeypatch):
    """A ``slab=True`` mesh (one rank, no process group) with two elements
    a rank: the slab forms step one element, so the part takes the block
    route, which has no split axis here.  3 ferrofluid steps (primed on the
    mesh: h stays in 19 channels, no premac; the solve on the psi route)
    and 3 HCZ steps, bit for bit to one device's batched steps on the same
    route."""
    slab = make_mesh(device="cpu", slab=True)
    params, state = worker.batch_state(B)
    part = pm.prime_premac(params, shard_state(state, slab), mesh=slab)
    assert part.premac is None and part.h.shape[:2] == (B, 19)
    hp, hs = pm.multiphase_3d(res=(8, 8, 10), batch=B, device="cpu")
    noise = torch.from_numpy(np.random.default_rng(9).uniform(-1, 1, hs.f.shape))
    noise[0] = 0
    hs = hs.replace(f=(hs.f * (1 + 1e-3 * noise)).to(hs.f.dtype))
    hpart = shard_state(hs, slab)
    for _ in range(3):
        part = pm.ferrofluid_step(params, part, mesh=slab)
        hpart = pm.hcz_step(hp, hpart, mesh=slab)
    monkeypatch.setattr(poisson, "emit_ok", lambda *a, **kw: False)
    one, hone = pm.prime_premac(params, state, device="cpu"), hs
    for _ in range(3):
        one = pm.ferrofluid_step(params, one, device="cpu")
        hone = pm.hcz_step(hp, hone, device="cpu")
    for k in ("f", "g", "h", "rho", "vel", "density", "pressure", "phi"):
        assert torch.equal(getattr(part, k), getattr(one, k)), k
    for k in ("f", "g", "rho", "vel", "density", "pressure"):
        assert torch.equal(getattr(hpart, k), getattr(hone, k)), f"HCZ {k}"


def test_scalar_carry_and_capillogue_at_b2_raise():
    """A batch carries no scalar carry or 6-leaf premac (B1 and B3 have no
    batch form); one made by hand from primed elements raises."""
    params, state = pm.rosensweig_3d(res=(8, 8, 10), device="cpu")
    primed = pm.prime_premac(params, state, device="cpu")
    assert primed.h.shape[1] == 2 and len(primed.premac) == 6
    two = primed.replace(**{k: torch.cat([v, v]) for k, v in vars(primed).items()
                            if torch.is_tensor(v)},
                         premac=tuple(torch.cat([x, x]) for x in primed.premac))
    with pytest.raises(NotImplementedError, match="ROADMAP A12 slice 8"):
        pm.ferrofluid_step(params, two, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP A12 slice 8"):
        pm.ferrofluid_step(params, two.replace(premac=None), device="cpu")


def test_batch_mesh_two_elements_a_rank_bit_for_bit(tmp_path):
    """A (batch 2, z 1) mesh of 2 gloo ranks, B = 4: each rank steps its
    two elements batched, bit for bit to one device's B = 4 steps."""
    got = worker.run_batch(2, tmp_path, batch=4, steps=2)
    params, whole = worker.batch_state(4)
    state = pm.prime_premac(params, whole, device="cpu")
    for _ in range(2):
        state = pm.ferrofluid_step(params, state, device="cpu")
    want = worker._flat(pm.to_numpy(state))
    assert got["f"].shape[0] == 4
    for k in ("f", "g", "h", "rho", "vel", "density", "pressure", "phi"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_checkpoint_guard_and_diagnostics_of_a_batch(tmp_path):
    params, state = worker.batch_state(4)
    state = pm.ferrofluid_step(params, state, device="cpu")
    save_checkpoint(tmp_path / "b4.npz", state)
    back = load_checkpoint(tmp_path / "b4.npz", state)
    for k, v in vars(state).items():
        if torch.is_tensor(v):
            assert torch.equal(getattr(back, k), v), k
    assert torch.equal(pm.ferrofluid_step(params, back, device="cpu").f,
                       pm.ferrofluid_step(params, state, device="cpu").f)
    # the diagnostics sum (and take the largest speed) over the elements
    d = diagnostics(state.rho, state.vel)
    parts = [diagnostics(state.rho[b:b + 1], state.vel[b:b + 1]) for b in range(4)]
    assert torch.allclose(d["mass"], sum(p["mass"] for p in parts), rtol=1e-6)
    assert d["max_speed"] == max(p["max_speed"] for p in parts)
    # one bad element trips the runner's guard
    bad = state.replace(f=state.f.clone())
    bad.f[2, 0, 3, 3, 3] = float("nan")
    runner = pm.SimulationRunner(params, pm.ferrofluid_step, device="cpu")
    with pytest.raises(FloatingPointError, match="non-finite values in state.f"):
        runner.run(bad, 1, io_interval=1, nan_guard=True)
    assert runner.run(state, 1, io_interval=1, nan_guard=True).step == state.step + 1
