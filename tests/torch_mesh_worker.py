"""Ranks of the port's meshed step, for tests/test_torch_parallel.py,
tests/test_torch_parallel_channel.py (``run_routes``: the channel-form and
HCZ routes), tests/test_torch_batch.py (``run_batch``: a batch mesh with
several elements a rank) and tests/test_torch_psi_halo.py (``run_psi``:
the meshed solves' exchange options).

Imports torch, numpy and the port only: the test spawns these ranks as
processes (``spawn`` start method), which must not load JAX.  Each rank
joins a gloo process group on the CPU, builds the scene's whole state, cuts
its part (``shard_state``), primes and steps it on the mesh, gathers the
whole state and, on rank 0, writes it as numpy arrays (``to_numpy``) to
the job's output directory.
"""

from __future__ import annotations

import pathlib
import socket

import numpy as np

#: the JAX package's tests/test_sharded_step.py:_flagship scene
FLAGSHIP = dict(
    dim=3, density_gas=0.02381, density_fluid=0.2508, rho_gas=0.02381, rho_fluid=0.2508,
    kappa=0.01, tau_f=0.68, tau_g=0.68, gravity=1e-4, mag_strength=85.0,
    poisson_halo_depth=2, mag_flags_shell=True,
)
RES = (16, 8, 16)
OBSTACLE, FLUID = 2, 1


def flagship_fields(res=RES, batch=1, rho_gas=0.02381, rho_fluid=0.2508):
    """(rho, density, vel, flags, magnetic_flags) of the flagship scene:
    an obstacle box, a magnetic domain open in y, a liquid pool at y < Y/2."""
    flags = np.full((batch, 1, *res), OBSTACLE, np.uint8)
    flags[..., 1:-1, 1:-1, 1:-1] = FLUID
    mflags = np.full((batch, 1, *res), OBSTACLE, np.uint8)
    mflags[..., 1:-1, :, 1:-1] = FLUID
    rho = np.full((batch, 1, *res), rho_gas, np.float32)
    den = np.full((batch, 1, *res), rho_gas, np.float32)
    rho[..., : res[1] // 2, :] = rho_fluid
    den[..., : res[1] // 2, :] = rho_fluid
    vel = np.zeros((batch, 3, *res), np.float32)
    return rho, den, vel, flags, mflags


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


#: the meshed step's routes: Z the capillogue steady state (6-leaf premac),
#: E the epilogue steady state (its first 5 leaves), O an out-of-plane
#: field (h_ext_axis=2, primed to 5 leaves), U the un-carried step with the
#: scalar carry (premac None)
ROUTES = ("Z", "E", "O", "U")


def port_state(poisson_iters, batch=1, route="Z"):
    from lbm_ferrofluid_tpu_torch.models import SimulationParams, init_ferrofluid_state

    params = SimulationParams(poisson_iters=poisson_iters, **FLAGSHIP,
                              h_ext_axis=2 if route == "O" else 1)
    return params, init_ferrofluid_state(params, *flagship_fields(batch=batch), device="cpu")


def on_route(state, route):
    """A primed state put on ``route``: E keeps 5 of the 6 leaves, U none."""
    if route == "E":
        return state.replace(premac=state.premac[:5])
    if route == "U":
        return state.replace(premac=None)
    return state


def rank_main(rank, world, port, shape, slab, poisson_iters, batch, steps, out_dir,
              checkpoint, route="Z"):
    """One rank: prime and ``steps`` meshed steps of the flagship scene on
    ``route``; rank 0 writes ``steps.npz`` (the gathered state) and, with
    ``checkpoint``, ``resumed.npz``: the state after ``steps - 1`` steps
    gathered, saved, loaded into a freshly primed template, re-cut and
    stepped once."""
    import torch
    import torch.distributed as dist

    from lbm_ferrofluid_tpu_torch.models import ferrofluid_step, prime_premac
    from lbm_ferrofluid_tpu_torch.models.state import to_numpy
    from lbm_ferrofluid_tpu_torch.parallel import (
        gather_state, initialize_distributed, make_mesh, shard_state,
    )
    from lbm_ferrofluid_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

    torch.set_num_threads(1)
    out = pathlib.Path(out_dir)
    assert initialize_distributed(f"127.0.0.1:{port}", world, rank, backend="gloo") == world
    try:
        mesh = make_mesh(("batch", "z"), shape, device="cpu", slab=slab)
        params, whole = port_state(poisson_iters, batch, route)

        def fresh():
            return on_route(prime_premac(params, shard_state(whole, mesh), mesh=mesh), route)

        state = fresh()
        assert state.h.shape[1] == 2
        assert (None if state.premac is None else len(state.premac)) == {
            "Z": 6, "E": 5, "O": 5, "U": None}[route]
        for i in range(steps):
            if checkpoint and i == steps - 1:
                before = gather_state(state, mesh)
                if rank == 0:
                    save_checkpoint(out / "ckpt.npz", before)
                dist.barrier()
                resumed = shard_state(load_checkpoint(out / "ckpt.npz", gather_state(
                    fresh(), mesh)), mesh)
                resumed = ferrofluid_step(params, resumed, mesh=mesh)
            state = ferrofluid_step(params, state, mesh=mesh)
        whole_out = gather_state(state, mesh)
        if checkpoint:
            resumed = gather_state(resumed, mesh)
        if rank == 0:
            np.savez(out / "steps.npz", **_flat(to_numpy(whole_out)))
            if checkpoint:
                np.savez(out / "resumed.npz", **_flat(to_numpy(resumed)))
    finally:
        dist.destroy_process_group()


#: the routes of the channel-form solve and the HCZ step on z-slabs: C the
#: capillogue steady state with the 19-channel h (primed to 6 leaves, h kept
#: at tau 0.8 without the scalar carry), U19 the un-carried step on that h
#: (never primed), CM route C where an interior magnetic obstacle on the
#: slabs' inner face planes keeps h in 19 channels (tau 1, no declared
#: shell); H the HCZ step on multiphase_3d with velocities pinned across
#: the inner faces, HD on droplet_spread_3d (gravity, the wetting floor)
CHANNEL_ROUTES = ("C", "U19", "CM")
HCZ_ROUTES = ("H", "HD")
CHANNEL = dict(scalar_carry=False, tau=0.8)
HCZ_RES = (16, 8, 12)
#: the planes on either side of the inner faces of 2 and 4 slabs of 16
FACE_PLANES = [3, 4, 7, 8, 11, 12]


def channel_config(route, batch=1):
    """(params keywords, (rho, density, vel, flags, magnetic_flags)) of a
    channel-form route's flagship scene."""
    kw = dict(FLAGSHIP, h_ext_axis=1)
    fields = flagship_fields(batch=batch)
    if route == "CM":
        kw["mag_flags_shell"] = False
        fields[4][..., FACE_PLANES, 3:5, 5:7] = OBSTACLE
    else:
        kw.update(CHANNEL)
    return kw, fields


def hcz_pins(res=HCZ_RES):
    """(mask [1, 1, *res] bool, value [1, 3, *res] float32): a row of pinned
    velocities in each plane of ``FACE_PLANES``."""
    mask = np.zeros((1, 1, *res), bool)
    mask[:, :, FACE_PLANES, 2, 3:9] = True
    value = np.zeros((1, 3, *res), np.float32)
    value[:, 0], value[:, 1], value[:, 2] = 0.01, -0.005, 0.002
    return mask, value


def route_state(route, poisson_iters=3):
    """(params, whole state on the CPU, step function) of a route of
    ``CHANNEL_ROUTES`` or ``HCZ_ROUTES``, before priming."""
    import torch

    from lbm_ferrofluid_tpu_torch import models

    if route in HCZ_ROUTES:
        build = models.multiphase_3d if route == "H" else models.droplet_spread_3d
        params, state = build(res=HCZ_RES, device="cpu")
        if route == "H":
            mask, value = hcz_pins()
            state = state.replace(vel_pin_mask=torch.from_numpy(mask),
                                  vel_pin_value=torch.from_numpy(value))
        return params, state, models.hcz_step
    kw, fields = channel_config(route)
    params = models.SimulationParams(poisson_iters=poisson_iters, **kw)
    return params, models.init_ferrofluid_state(params, *fields, device="cpu"), \
        models.ferrofluid_step


def prime_route(params, state, route, **where):
    """A route's state as it steps: C and CM primed (``where``: ``mesh=``
    or ``device=``), the others as built."""
    from lbm_ferrofluid_tpu_torch.models import prime_premac

    return prime_premac(params, state, **where) if route in ("C", "CM") else state


def routes_main(rank, world, port, routes, poisson_iters, steps, out_dir):
    """One rank of a job of several routes on a z mesh of ``world`` ranks:
    each route's whole state cut to the rank's slab, primed as the route
    asks, ``steps`` meshed steps, gathered; rank 0 writes
    ``<route>.npz``."""
    import torch
    import torch.distributed as dist

    from lbm_ferrofluid_tpu_torch.models.state import to_numpy
    from lbm_ferrofluid_tpu_torch.parallel import (
        gather_state, initialize_distributed, make_mesh, shard_state,
    )

    torch.set_num_threads(1)
    out = pathlib.Path(out_dir)
    assert initialize_distributed(f"127.0.0.1:{port}", world, rank, backend="gloo") == world
    try:
        mesh = make_mesh(("batch", "z"), (1, world), device="cpu")
        for route in routes:
            params, whole, step = route_state(route, poisson_iters)
            state = prime_route(params, shard_state(whole, mesh), route, mesh=mesh)
            if route in CHANNEL_ROUTES:
                assert state.h.shape[1] == 19
                assert (state.premac is None) == (route == "U19")
            for _ in range(steps):
                state = step(params, state, mesh=mesh)
            whole_out = gather_state(state, mesh)
            if rank == 0:
                np.savez(out / f"{route}.npz", **_flat(to_numpy(whole_out)))
    finally:
        dist.destroy_process_group()


def run_routes(world, out_dir, routes, poisson_iters, steps):
    """Spawn ``world`` ranks of :func:`routes_main`: {route: the gathered
    state's arrays}."""
    import torch.multiprocessing as mp

    mp.start_processes(routes_main, args=(world, free_port(), tuple(routes), poisson_iters,
                                          steps, str(out_dir)),
                       nprocs=world, start_method="spawn")
    return {r: dict(np.load(pathlib.Path(out_dir) / f"{r}.npz")) for r in routes}


def _flat(fields):
    out = {}
    for k, v in fields.items():
        if isinstance(v, tuple):
            out.update({f"{k}.{i}": x for i, x in enumerate(v) if x is not None})
        elif v is not None:
            out[k] = v
    return out


def sweeps_main(rank, world, port, out_dir, tau, n_iters):
    """One rank of ``halo.sharded_poisson_sweeps``: cuts its z-slab of the
    channel-form inputs in ``out_dir/sweeps_in.npz`` (h, flags, rhs), runs
    the sweeps on a z mesh of ``world`` ranks and writes its slab of (h,
    psi) to ``sweeps_<rank>.npz``."""
    import torch
    import torch.distributed as dist

    from lbm_ferrofluid_tpu_torch.parallel import (
        initialize_distributed, make_mesh, sharded_poisson_sweeps,
    )

    torch.set_num_threads(1)
    out = pathlib.Path(out_dir)
    assert initialize_distributed(f"127.0.0.1:{port}", world, rank, backend="gloo") == world
    try:
        mesh = make_mesh(("batch", "z"), (1, world), device="cpu")
        inputs = np.load(out / "sweeps_in.npz")
        Zl = inputs["h"].shape[2] // world
        h, flags, rhs = (torch.from_numpy(inputs[k][:, :, rank * Zl:(rank + 1) * Zl].copy())
                         for k in ("h", "flags", "rhs"))
        h, psi = sharded_poisson_sweeps(h, flags, rhs, mesh, tau=tau, n_iters=n_iters)
        np.savez(out / f"sweeps_{rank}.npz", h=h.numpy(), psi=psi.numpy())
    finally:
        dist.destroy_process_group()


def run_sweeps(world, out_dir, h, flags, rhs, *, tau, n_iters):
    """``sharded_poisson_sweeps`` on ``world`` spawned z ranks; returns the
    gathered (h, psi)."""
    import torch.multiprocessing as mp

    out = pathlib.Path(out_dir)
    np.savez(out / "sweeps_in.npz", h=h, flags=flags, rhs=rhs)
    mp.start_processes(sweeps_main, args=(world, free_port(), str(out), tau, n_iters),
                       nprocs=world, start_method="spawn")
    parts = [np.load(out / f"sweeps_{r}.npz") for r in range(world)]
    return tuple(np.concatenate([p[k] for p in parts], axis=2) for k in ("h", "psi"))


#: the meshed channel-form solve's cases with the static field (name: grid,
#: sweeps) on 2 z ranks: the last round emits H2 (6 sweeps: two rounds of
#: 3, the second from 4-plane bands taken from h), k clamped by the last
#: round's spare band plane (3-plane slabs: rounds of 2 where the psi
#: route takes one of 3), a remainder round (7 sweeps: 4, then 3 from
#: 4-plane bands), and the psi route (2 cells in y: no interior row for
#: the output's ring, so the plan refuses the trailing stage)
H2_CASES = {"h2": ((16, 8, 12), 6), "clamped": ((6, 8, 12), 6), "remainder": ((16, 8, 12), 7),
            "psi_route": ((8, 2, 12), 6)}
H2_FIELD = (0.0, 85.0, 0.0)


def h2_inputs(res, seed=21):
    """(h, magnetic flags, rhs) of a meshed solve's case: the magnetic
    shell (z edge planes, x edge columns) and obstacles on every z plane of
    a column crossing the faces of 2 slabs, h and the source from the
    seed."""
    rng = np.random.default_rng(seed)
    mf = np.full((1, 1, *res), OBSTACLE, np.uint8)
    mf[..., 1:-1, :, 1:-1] = FLUID
    mf[..., :, res[1] // 2, 3:5] = OBSTACLE
    h = rng.uniform(-0.1, 0.1, (1, 19, *res)).astype(np.float32)
    rhs = (rng.uniform(-1e-2, 1e-2, (1, 1, *res)) * (mf == FLUID)).astype(np.float32)
    return h, mf, rhs


def h2_main(rank, world, port, out_dir, cases):
    """One rank of the meshed solve (``ops/magnetic.py:solve_H_int`` with
    ``mesh`` and the static field) on each case of :data:`H2_CASES`: writes
    its slab of (H2, h'), the route (``emitted``: no call of B10a's slab
    form) and the plans' k to ``h2_<case>_<rank>.npz``."""
    import torch
    import torch.distributed as dist

    from lbm_ferrofluid_tpu_torch.lattice import D3Q19
    from lbm_ferrofluid_tpu_torch.ops import solve_H_int
    from lbm_ferrofluid_tpu_torch.parallel import initialize_distributed, make_mesh, step3d

    torch.set_num_threads(1)
    out = pathlib.Path(out_dir)
    grads = []
    real = step3d.grad_fields_sharded
    step3d.grad_fields_sharded = lambda *a, **kw: grads.append(1) or real(*a, **kw)
    assert initialize_distributed(f"127.0.0.1:{port}", world, rank, backend="gloo") == world
    try:
        mesh = make_mesh(("batch", "z"), (1, world), device="cpu")
        for case in cases:
            res, n = H2_CASES[case]
            Zl = res[0] // world
            h, mf, rhs = (torch.from_numpy(a[:, :, rank * Zl:(rank + 1) * Zl].copy())
                          for a in h2_inputs(res))
            del grads[:]
            H2, h = solve_H_int(D3Q19, h, None, mf, None, tau=0.8, n_iters=n, rhs_scaled=rhs,
                                h2_ext=H2_FIELD, mesh=mesh)
            plans = [step3d.channel_slab_plan(mesh, (1, 19, *res), n, h2=h2)
                     for h2 in (True, False)]
            np.savez(out / f"h2_{case}_{rank}.npz", H2=H2.numpy(), h=h.numpy(),
                     emitted=not grads, k=[p[0] if p else 0 for p in plans])
    finally:
        step3d.grad_fields_sharded = real
        dist.destroy_process_group()


def run_h2(world, out_dir, cases):
    """:func:`h2_main` on ``world`` spawned z ranks: {case: (H2, h',
    emitted, (k of the h2 plan or 0, k of the psi plan))}, gathered."""
    import torch.multiprocessing as mp

    mp.start_processes(h2_main, args=(world, free_port(), str(out_dir), tuple(cases)),
                       nprocs=world, start_method="spawn")
    res = {}
    for case in cases:
        parts = [np.load(pathlib.Path(out_dir) / f"h2_{case}_{r}.npz") for r in range(world)]
        res[case] = (np.concatenate([p["H2"] for p in parts], axis=2),
                     np.concatenate([p["h"] for p in parts], axis=2),
                     [bool(p["emitted"]) for p in parts], tuple(parts[0]["k"]))
    return res


def batch_state(batch, poisson_iters=3, seed=5):
    """(params, whole state) of the flagship scene at a batch of ``batch``
    elements that all differ: each element's f, g and h moved by noise from
    its own seed (f and g by a relative 1e-3, h by 1e-4), so that a step in
    which one element reads another shows it."""
    import torch

    params, state = port_state(poisson_iters, batch)
    noisy = {}
    for name, scale, relative in (("f", 1e-3, True), ("g", 1e-3, True), ("h", 1e-4, False)):
        x = getattr(state, name).numpy().copy()
        for b in range(batch):
            n = np.random.default_rng(seed + 101 * b).uniform(-1, 1, x[b].shape)
            x[b] = x[b] * (1 + scale * n) if relative else x[b] + scale * n
        noisy[name] = torch.from_numpy(x.astype(np.float32))
    return params, state.replace(**noisy)


def batch_main(rank, world, port, batch, steps, out_dir):
    """One rank of a batch mesh (``world`` ranks on the batch axis, z 1)
    of :func:`batch_state`: each rank primes (a no-op at more than one
    element a rank) and steps its ``batch // world`` elements batched on
    the single-device route; rank 0 writes the gathered state to
    ``batch.npz``."""
    import torch
    import torch.distributed as dist

    from lbm_ferrofluid_tpu_torch.models import ferrofluid_step, prime_premac
    from lbm_ferrofluid_tpu_torch.models.state import to_numpy
    from lbm_ferrofluid_tpu_torch.parallel import (
        gather_state, initialize_distributed, make_mesh, shard_state,
    )

    torch.set_num_threads(1)
    assert initialize_distributed(f"127.0.0.1:{port}", world, rank, backend="gloo") == world
    try:
        mesh = make_mesh(("batch", "z"), (world, 1), device="cpu")
        params, whole = batch_state(batch)
        state = prime_premac(params, shard_state(whole, mesh), mesh=mesh)
        assert state.f.shape[0] == batch // world and state.premac is None
        assert state.h.shape[1] == 19
        for _ in range(steps):
            state = ferrofluid_step(params, state, mesh=mesh)
        whole_out = gather_state(state, mesh)
        if rank == 0:
            np.savez(pathlib.Path(out_dir) / "batch.npz", **_flat(to_numpy(whole_out)))
    finally:
        dist.destroy_process_group()


def run_batch(world, out_dir, batch, steps):
    """:func:`batch_main` on ``world`` spawned ranks: the gathered state's
    arrays."""
    import torch.multiprocessing as mp

    mp.start_processes(batch_main, args=(world, free_port(), batch, steps, str(out_dir)),
                       nprocs=world, start_method="spawn")
    return dict(np.load(pathlib.Path(out_dir) / "batch.npz"))


def run_ranks(world, out_dir, **job):
    """Spawn ``world`` ranks of :func:`rank_main` on a free port and wait
    for them (a failure or a hang of any rank raises)."""
    import torch.multiprocessing as mp

    mp.start_processes(rank_main, args=(world, free_port(), *(job[k] for k in (
        "shape", "slab", "poisson_iters", "batch", "steps")), str(out_dir),
        job.get("checkpoint", False), job.get("route", "Z")), nprocs=world,
        start_method="spawn")
    return dict(np.load(pathlib.Path(out_dir) / "steps.npz"))


# ------------------------------------------------------------------ 2D on y/x meshes
#: the 2D cases on y/x meshes: (model, grid, params change, prime).  bgk and
#: kbc: the JAX package's tests/test_sharding.py single-phase scene
#: (32x16, tau 0.6, velocities from a seed), with KBC_A for kbc; sc: the
#: Shan-Chen drop; hcz: that file's HCZ scene (16x24: a box of liquid in an
#: obstacle frame, contact angle 0.75 pi, gravity 1e-4), hcz_kbc
#: droplet_spread_2d (the wetting floor, KBC_A on g); scalar and channel:
#: rosensweig_2d with h in the scalar carry (primed) and in 9 channels,
#: bf16 the scalar carry with f, g and h stored in bfloat16
MESH2D_CASES = {
    "bgk": ("single", (32, 16), {}, False),
    "kbc": ("single", (32, 16), {"kbc_type": 1}, False),
    "sc": ("sc", (16, 24), {}, False),
    "hcz": ("hcz", (16, 24), {}, False),
    "hcz_kbc": ("hcz_kbc", (16, 24), {}, False),
    "scalar": ("ferro", (16, 24), {}, True),
    "channel": ("ferro", (16, 24), {"scalar_carry": False}, True),
    "bf16": ("ferro", (16, 24), {"fg_dtype": "bfloat16", "h_dtype": "bfloat16"}, True),
}
#: the step a model takes (``lbm_ferrofluid_tpu_torch.models`` names)
MESH2D_STEPS = {"single": "singlephase_step", "sc": "sc_step", "hcz": "hcz_step",
                "hcz_kbc": "hcz_step", "ferro": "ferrofluid_step"}


def mesh2d_fields(model, res, batch=1, seed=3):
    """(params keywords, numpy fields) of a 2D case's whole state: each
    batch element's velocity (the single-phase scene) or density moved by
    its own noise from ``seed``."""
    OBS = OBSTACLE
    rng = np.random.default_rng(seed)
    H, W = res
    flags = np.full((batch, 1, H, W), FLUID, np.uint8)
    vel = np.zeros((batch, 2, H, W), np.float32)
    if model == "single":
        rho = np.full((batch, 1, H, W), 0.265, np.float32)
        vel[:] = rng.uniform(-0.05, 0.05, vel.shape)
        return dict(dim=2, tau=0.6), dict(rho=rho, vel=vel, flags=flags)
    mp = dict(density_gas=0.02381, density_fluid=0.2508, rho_gas=0.02381, rho_fluid=0.2508)
    flags[..., 0, :] = flags[..., -1, :] = OBS
    flags[..., :, 0] = flags[..., :, -1] = OBS
    rho = np.full((batch, 1, H, W), mp["rho_gas"], np.float32)
    if model == "hcz_kbc":  # droplet_spread_2d's half disc on the floor
        r = 0.6 * max(res) / 2
        j, i = np.arange(H)[:, None], np.arange(W)[None, :]
        rho[:, 0][..., j * j + (i - W / 2) ** 2 <= r * r] = mp["rho_fluid"]
        kw = dict(kappa=0.1, tau_f=0.7, tau_g=0.8, gravity=1e-5,
                  contact_angle=0.75 * np.pi, kbc_type=1)
    elif model == "ferro":  # rosensweig_2d's pool
        rho[..., : int(0.45 * H), :] = mp["rho_fluid"]
        kw = dict(kappa=0.01, tau_f=0.7, tau_g=0.8, gravity=1e-4, contact_angle=0.75 * np.pi,
                  mag_strength=100.0, poisson_iters=30, kbc_type=1)
    else:
        rho[..., H // 4: 3 * H // 4, W // 4: 3 * W // 4] = mp["rho_fluid"]
        kw = dict(kappa=0.08, tau_f=0.7, tau_g=0.8, contact_angle=0.75 * np.pi, gravity=1e-4)
        if model == "sc":
            kw = dict(tau=1.0)
    rho = (rho * (1 + 1e-3 * rng.uniform(-1, 1, rho.shape))).astype(np.float32)
    den = rho.copy()
    fields = dict(rho=rho, density=den, vel=vel, flags=flags)
    if model == "ferro":
        mflags = np.full((batch, 1, H, W), OBS, np.uint8)
        mflags[..., :, 1:-1] = FLUID
        fields["magnetic_flags"] = mflags
    return dict(dim=2, **mp, **kw), fields


def mesh2d_state(case, batch=1, res=None, storage=None):
    """(params, whole state) of a case of :data:`MESH2D_CASES` on the CPU
    (``res`` overrides its grid)."""
    from lbm_ferrofluid_tpu_torch import models as pm

    model, grid, change, _ = MESH2D_CASES[case]
    kw, fd = mesh2d_fields(model, res or grid, batch)
    params = pm.SimulationParams(**kw).replace(**change)
    if model == "single":
        return params, pm.init_singlephase_state(params, fd["rho"], fd["vel"], fd["flags"],
                                                 device="cpu")
    args = (params, fd["rho"], fd["density"], fd["vel"], fd["flags"])
    if model == "sc":
        return params, pm.init_sc_state(*args, device="cpu")
    if model == "ferro":
        return params, pm.init_ferrofluid_state(*args, fd["magnetic_flags"], device="cpu")
    return params, pm.init_hcz_state(*args, device="cpu")


def mesh2d_main(rank, world, port, axes, shape, jobs, steps, out_dir):
    """One rank of 2D steps on a ('batch', 'y', 'x') mesh: for each job
    (case, batch, grid or None), the whole state built on every rank, this
    rank's block cut,
    primed where the case primes, ``steps`` meshed steps through the
    model's entry point, gathered; rank 0 writes ``<job>.npz`` with the
    exchanges and bytes a step (``stats.``).  A job named ``roundtrip``
    writes the whole state cut and gathered again, and this rank's
    ``H_ext_mac`` shapes; a job named ``runner...`` steps through
    ``SimulationRunner(..., mesh=)``, which primes."""
    import torch
    import torch.distributed as dist

    from lbm_ferrofluid_tpu_torch import models as pm
    from lbm_ferrofluid_tpu_torch.models.state import to_numpy
    from lbm_ferrofluid_tpu_torch.parallel import (
        gather_state, initialize_distributed, make_mesh, ring_halo, shard_state,
    )

    torch.set_num_threads(1)
    out_dir = pathlib.Path(out_dir)
    assert initialize_distributed(f"127.0.0.1:{port}", world, rank, backend="gloo") == world
    try:
        mesh = make_mesh(axes, shape, device="cpu")
        for name, (case, batch, res) in jobs.items():
            params, whole = mesh2d_state(case, batch, res)
            st = shard_state(whole, mesh)
            if name == "roundtrip":
                back = gather_state(st, mesh)
                if rank == 0:
                    np.savez(out_dir / f"{name}.npz", **_flat(to_numpy(back)),
                             mac_shapes=np.array([t.shape for t in st.H_ext_mac]))
                continue
            step = getattr(pm, MESH2D_STEPS[MESH2D_CASES[case][0]])
            if name.startswith("runner"):
                n0, b0 = ring_halo.exchanges, ring_halo.sent_bytes
                st = pm.SimulationRunner(params, step, mesh=mesh).run(st, steps)
            else:
                if MESH2D_CASES[case][3]:
                    st = pm.prime_premac(params, st, mesh=mesh)
                n0, b0 = ring_halo.exchanges, ring_halo.sent_bytes
                for _ in range(steps):
                    st = step(params, st, mesh=mesh)
            stats = dict(exchanges=(ring_halo.exchanges - n0) / steps,
                         bytes=(ring_halo.sent_bytes - b0) / steps)
            out = gather_state(st, mesh)
            if rank == 0:
                np.savez(out_dir / f"{name}.npz", **_flat(to_numpy(out)),
                         **{"stats." + key: v for key, v in stats.items()})
    finally:
        dist.destroy_process_group()


def run_mesh2d(out_dir, axes, shape, jobs, steps=5):
    """:func:`mesh2d_main` on the ranks of ``shape`` (spawned): {job: the
    gathered state's arrays}."""
    import math

    import torch.multiprocessing as mp

    world = math.prod(shape)
    mp.start_processes(mesh2d_main, args=(world, free_port(), tuple(axes), tuple(shape), jobs,
                                          steps, str(out_dir)),
                       nprocs=world, start_method="spawn")
    return {name: dict(np.load(pathlib.Path(out_dir) / f"{name}.npz")) for name in jobs}


# ------------------------------------------------------------------ 3D on blocks
#: the JAX package's tests/test_sharding.py flagship scene's parameters (on
#: ``flagship_fields``' arrays at 16x8x16, with no declared shell)
SHARDING_3D = dict(
    dim=3, density_gas=0.02381, density_fluid=0.2508, rho_gas=0.02381, rho_fluid=0.2508,
    kappa=0.01, tau_f=0.68, tau_g=0.68, gravity=1e-4, mag_strength=85.0, poisson_iters=5,
)
BF16 = {"fg_dtype": "bfloat16", "h_dtype": "bfloat16"}
#: the 3D cases on the block route: (model, params change).  scalar: the
#: flagship scene with h in the scalar carry (primed on the mesh); channel:
#: at tau 0.8 (the 19-channel h); channel_obs: at tau 1 with magnetic
#: obstacles inside the domain, across the blocks' seams (the collapse does
#: not apply); the _bf16 cases with f, g and h stored in bfloat16; hcz:
#: HCZ on the flagship pool (its density moved by seeded noise); bgk:
#: single phase with velocities from a seed around an obstacle block; sc:
#: Shan-Chen on the noisy pool
MESH3D_CASES = {
    "scalar": ("ferro", {}),
    "channel": ("ferro", {"tau": 0.8}),
    "channel_obs": ("ferro_obs", {}),
    "scalar_bf16": ("ferro", BF16),
    "channel_bf16": ("ferro", dict(BF16, tau=0.8)),
    "hcz": ("hcz", {}),
    "bgk": ("single", {}),
    "sc": ("sc", {}),
}
#: the step a model takes (``lbm_ferrofluid_tpu_torch.models`` names)
MESH3D_STEPS = {"ferro": "ferrofluid_step", "ferro_obs": "ferrofluid_step",
                "hcz": "hcz_step", "single": "singlephase_step", "sc": "sc_step",
                "padded": "ferrofluid_step"}
#: the padded transposed layout (``scenes.rosensweig_3d_tpu``), a case of
#: its own: its job's grid is the physical (z, y, x) of the scene, whose
#: arrays are (y, z rounded up to 8, x rounded up to 128)
PADDED = "padded"


def case_model(case):
    """The model of a 3D case: :data:`MESH3D_CASES`' or the padded layout."""
    return PADDED if case == PADDED else MESH3D_CASES[case][0]


def mesh3d_fields(model, res, seed=11, batch=1):
    """(params keywords, numpy fields) of a 3D case's whole state; a batch
    of more than one has every element's density (or, single phase, its
    velocity) moved by noise from its own seed, so that a step in which one
    element reads another shows it."""
    rho, den, vel, flags, mflags = flagship_fields(res, batch)
    rng = np.random.default_rng(seed)
    if batch > 1 and model != "single":
        for b in range(batch):
            n = np.random.default_rng(seed + 101 * b).uniform(-1, 1, rho[b].shape)
            rho[b] = (rho[b] * (1 + 1e-3 * n)).astype(np.float32)
    if model == "single":
        vel = rng.uniform(-0.05, 0.05, vel.shape).astype(np.float32)
        flags = np.full_like(flags, FLUID)
        Z, Y, X = res
        flags[..., Z // 4:Z // 2, 2:Y // 2, X // 4:X // 2] = OBSTACLE
        return dict(dim=3, tau=0.6), dict(rho=np.full_like(rho, 0.265), vel=vel, flags=flags)
    if model in ("sc", "hcz"):
        rho = (rho * (1 + 1e-3 * rng.uniform(-1, 1, rho.shape))).astype(np.float32)
    fields = dict(rho=rho, density=rho.copy(), vel=vel, flags=flags)
    if model == "sc":
        return dict(SHARDING_3D, tau=1.0), fields
    if model == "hcz":
        return dict(SHARDING_3D, kappa=0.08, tau_f=0.7, tau_g=0.8,
                    contact_angle=0.75 * np.pi), fields
    if model == "ferro_obs":
        Z, Y, X = res
        mflags[..., Z // 2 - 1:Z // 2 + 1, Y // 2 - 1:Y // 2 + 1, X // 2 - 2:X // 2 + 2] = OBSTACLE
    fields["magnetic_flags"] = mflags
    return dict(SHARDING_3D), fields


def mesh3d_state(case, res=RES, batch=1):
    """(params, whole state) of a case of :data:`MESH3D_CASES` on the CPU,
    at a batch of ``batch`` elements (:func:`mesh3d_fields`)."""
    from lbm_ferrofluid_tpu_torch import models as pm

    if case == PADDED:
        return pm.rosensweig_3d_tpu(res=tuple(res), batch=batch, device="cpu")
    model, change = MESH3D_CASES[case]
    kw, fd = mesh3d_fields(model, res, batch=batch)
    params = pm.SimulationParams(**kw).replace(**change)
    if model == "single":
        return params, pm.init_singlephase_state(params, fd["rho"], fd["vel"], fd["flags"],
                                                 device="cpu")
    args = (params, fd["rho"], fd["density"], fd["vel"], fd["flags"])
    if model == "sc":
        return params, pm.init_sc_state(*args, device="cpu")
    if model == "hcz":
        return params, pm.init_hcz_state(*args, device="cpu")
    return params, pm.init_ferrofluid_state(*args, fd["magnetic_flags"], device="cpu")


def mesh3d_main(rank, world, port, axes, shape, jobs, steps, out_dir):
    """One rank of 3D steps on a mesh over ``axes``: for each job (case,
    grid[, batch]), the whole state built on every rank, this rank's block cut,
    primed on the mesh where the model is the ferrofluid step, ``steps``
    meshed steps through the model's entry point, gathered; rank 0 writes
    ``<job>.npz`` with the exchanges and bytes a step (``stats.``), whether
    priming left a premac (``stats.premac``) and of how many leaves
    (``stats.premac_leaves``), and h's channels after priming
    (``stats.primed_h``).  A job named
    ``u19...`` is never primed (the un-carried step on the 19-channel h:
    route U19 where the rank part takes the slab forms).  A job named
    ``runner...`` steps through ``SimulationRunner(..., mesh=)``, which
    primes, with an ``io_fn`` at every step that gathers the whole state
    (``stats.io_calls``, and ``stats.io_whole``: every gather whole)."""
    import torch
    import torch.distributed as dist

    from lbm_ferrofluid_tpu_torch import models as pm
    from lbm_ferrofluid_tpu_torch.models.state import to_numpy
    from lbm_ferrofluid_tpu_torch.parallel import (
        gather_state, initialize_distributed, make_mesh, ring_halo, shard_state,
    )

    torch.set_num_threads(1)
    out_dir = pathlib.Path(out_dir)
    assert initialize_distributed(f"127.0.0.1:{port}", world, rank, backend="gloo") == world
    try:
        mesh = make_mesh(axes, shape, device="cpu")
        for name, (case, res, *batch) in jobs.items():
            params, whole = mesh3d_state(case, tuple(res), *batch)
            step = getattr(pm, MESH3D_STEPS[case_model(case)])
            st = shard_state(whole, mesh)
            n0, b0 = ring_halo.exchanges, ring_halo.sent_bytes
            if name.startswith("runner"):
                shapes = []

                def io_fn(state):
                    shapes.append(tuple(gather_state(state, mesh).f.shape))

                st = pm.SimulationRunner(params, step, mesh=mesh).run(
                    st, steps, io_interval=1, io_fn=io_fn, nan_guard=True)
                stats = dict(io_calls=len(shapes),
                             io_whole=all(sh == tuple(whole.f.shape) for sh in shapes),
                             premac=getattr(st, "premac", None) is not None)
            else:
                if step is pm.ferrofluid_step and not name.startswith("u19"):
                    st = pm.prime_premac(params, st, mesh=mesh)
                premac = getattr(st, "premac", None)
                primed = dict(premac=premac is not None, premac_leaves=len(premac or ()),
                              primed_h=st.h.shape[1] if hasattr(st, "h") else 0)
                n0, b0 = ring_halo.exchanges, ring_halo.sent_bytes
                for _ in range(steps):
                    st = step(params, st, mesh=mesh)
                stats = dict(exchanges=(ring_halo.exchanges - n0) / steps,
                             bytes=(ring_halo.sent_bytes - b0) / steps, **primed)
            out = gather_state(st, mesh)
            if rank == 0:
                np.savez(out_dir / f"{name}.npz", **_flat(to_numpy(out)),
                         **{"stats." + key: v for key, v in stats.items()})
    finally:
        dist.destroy_process_group()


def run_mesh3d(out_dir, axes, shape, jobs, steps=3):
    """:func:`mesh3d_main` on the ranks of ``shape`` (spawned): {job: the
    gathered state's arrays}."""
    import math

    import torch.multiprocessing as mp

    world = math.prod(shape)
    mp.start_processes(mesh3d_main, args=(world, free_port(), tuple(axes), tuple(shape), jobs,
                                          steps, str(out_dir)),
                       nprocs=world, start_method="spawn")
    return {name: dict(np.load(pathlib.Path(out_dir) / f"{name}.npz")) for name in jobs}


# ------------------------------------------------------------------ exchange options
#: the solves of ``run_psi`` on (batch, z) = (2, 2), each with its option
#: on and off: name -> (form, h's storage, sweeps, static field).  psi, h2
#: and bf16: the channel-form solve at tau 1 on the shell with
#: ``psi_halo`` (rounds of 3, the h2 final round on 4 planes); sliver: the
#: scalar carry with ``shell_sliver``
PSI_SOLVES = {"psi": ("channel", "float32", 30, False), "h2": ("channel", "float32", 30, True),
              "bf16": ("channel", "bfloat16", 30, True), "sliver": ("scalar", "float32", 12, True)}
#: the steps of ``run_psi``: the flagship at tau 1 without the scalar carry,
#: a batch of 2, primed on the mesh (C: one element a rank primes to the
#: capillogue steady state) or never (U19), each also with
#: ``poisson_psi_halo=False`` (``<route>_full``)
PSI_ROUTES = ("C", "U19")
PSI_STEPS = 3
PSI_ITERS = 12
PSI_FIELDS = ("f", "g", "h", "rho", "vel", "density", "pressure")
PSI_FIELD = (0.0, 85.0, 0.0)


def psi_config(b):
    """(params keywords, (rho, density, vel, flags, magnetic_flags)) of
    element ``b`` of ``run_psi``'s batch: the flagship scene at tau 1 with
    the scalar carry off, its rho moved by noise from the element's seed."""
    rho, den, vel, flags, mflags = flagship_fields()
    n = np.random.default_rng(5 + 101 * b).uniform(-1, 1, rho.shape)
    rho = (rho * (1 + 1e-3 * n)).astype(np.float32)
    kw = dict(FLAGSHIP, h_ext_axis=1, scalar_carry=False, poisson_iters=PSI_ITERS)
    return kw, (rho, rho.copy(), vel, flags, mflags)


def psi_state(change=None, batch=2):
    """(params, whole state) of ``run_psi``'s steps: the elements of
    :func:`psi_config` stacked."""
    from lbm_ferrofluid_tpu_torch.models import SimulationParams, init_ferrofluid_state

    kw, _ = psi_config(0)
    fields = [np.concatenate(parts) for parts in zip(*(psi_config(b)[1]
                                                        for b in range(batch)))]
    params = SimulationParams(**kw).replace(**(change or {}))
    return params, init_ferrofluid_state(params, *fields, device="cpu")


def psi_reference(route, b):
    """One device's ``PSI_STEPS`` steps of element ``b`` on ``route`` (C
    primed), as arrays."""
    from lbm_ferrofluid_tpu_torch.models import (
        SimulationParams, ferrofluid_step, init_ferrofluid_state, prime_premac,
    )
    from lbm_ferrofluid_tpu_torch.models.state import to_numpy

    kw, fields = psi_config(b)
    params = SimulationParams(**kw)
    st = init_ferrofluid_state(params, *fields, device="cpu")
    if route == "C":
        st = prime_premac(params, st, device="cpu")
    for _ in range(PSI_STEPS):
        st = ferrofluid_step(params, st, device="cpu")
    return _flat(to_numpy(st))


def psi_solve_inputs(form, storage, res=RES, seed=25):
    """The whole domain's inputs of a solve of :data:`PSI_SOLVES`: the
    shell's magnetic obstacles, h (or the scalar pair and its cmask) and
    the source from the seed."""
    import torch

    from lbm_ferrofluid_tpu_torch.ops.scalar_poisson import make_cmask

    rng = np.random.default_rng(seed)
    mf = np.full((1, 1, *res), OBSTACLE, np.uint8)
    mf[..., 1:-1, :, 1:-1] = FLUID
    rhs = torch.from_numpy((rng.uniform(-1e-2, 1e-2, (1, 1, *res)) * (mf == FLUID))
                           .astype(np.float32))
    mf = torch.from_numpy(mf)
    if form == "scalar":
        mask = (mf == FLUID).float()
        s2 = torch.cat([torch.from_numpy(rng.uniform(-1, 1, (1, 1, *res)).astype(np.float32))
                        * mask for _ in range(2)], dim=1)
        return s2, make_cmask(mf), rhs
    dt = getattr(torch, storage)
    return torch.from_numpy(rng.uniform(-0.1, 0.1, (1, 19, *res)).astype(np.float32)).to(dt), \
        mf, rhs


def psi_main(rank, world, port, out_dir):
    """One rank of (batch, z) = (2, 2): each solve of :data:`PSI_SOLVES`
    on its z slab with the option on and off (``ring_halo``'s bytes and
    exchanges counted around each, the outputs compared, the sliver's up to
    the sign of a zero), priming refused where a magnetic obstacle breaks
    the shell on a slab's edge plane (``check.shell_refused``), then each
    route of :data:`PSI_ROUTES` and its ``_full`` twin stepped
    ``PSI_STEPS`` times and gathered; rank 0 writes ``psi.npz``."""
    import torch
    import torch.distributed as dist

    from lbm_ferrofluid_tpu_torch.models import ferrofluid_step, prime_premac
    from lbm_ferrofluid_tpu_torch.models.state import to_numpy
    from lbm_ferrofluid_tpu_torch.parallel import (
        gather_state, initialize_distributed, make_mesh, ring_halo, shard_state, step3d,
    )

    torch.set_num_threads(1)
    assert initialize_distributed(f"127.0.0.1:{port}", world, rank, backend="gloo") == world
    out = {}
    try:
        mesh = make_mesh(("batch", "z"), (2, 2), device="cpu")
        Zl = RES[0] // mesh.nz
        for case, (form, storage, n, emit) in PSI_SOLVES.items():
            args = [x[:, :, mesh.iz * Zl:(mesh.iz + 1) * Zl].contiguous()
                    for x in psi_solve_inputs(form, storage)]
            res = {}
            for on in (True, False):
                n0, b0 = ring_halo.exchanges, ring_halo.sent_bytes
                if form == "scalar":
                    got = step3d.scalar_poisson_sharded(*args, mesh, n_iters=n, h_ext=PSI_FIELD,
                                                        shell_sliver=on)
                    got = [x + 0.0 for x in got]  # -0.0 + 0.0 is +0.0
                else:
                    got = step3d.poisson_sweeps_sharded(
                        *args, mesh, tau=1.0, n_iters=n, psi_halo=on,
                        emit_h2=PSI_FIELD if emit else None)[:2]
                res[on] = got
                tag = "on" if on else "off"
                out[f"solve.{case}.bytes_{tag}"] = ring_halo.sent_bytes - b0
                out[f"solve.{case}.exchanges_{tag}"] = ring_halo.exchanges - n0
            equal = all(torch.equal(a, b) for a, b in zip(res[True], res[False]))
            every = [None] * world
            dist.all_gather_object(every, equal)
            out[f"solve.{case}.equal"] = all(every)
        # the shell declaration checked over the whole domain at priming: a
        # magnetic obstacle off the shell on slab 0's top plane, which that
        # slab's own interior does not hold
        params, whole = psi_state()
        mf = whole.magnetic_flags.clone()
        mf[:, :, Zl - 1, 3, 5] = OBSTACLE
        try:
            prime_premac(params, shard_state(whole.replace(magnetic_flags=mf), mesh), mesh=mesh)
            out["check.shell_refused"] = False
        except ValueError as e:
            out["check.shell_refused"] = "mag_flags_shell" in str(e)
        for route in PSI_ROUTES:
            for full in (False, True):
                params, whole = psi_state({"poisson_psi_halo": False} if full else None)
                st = shard_state(whole, mesh)
                if route == "C":
                    st = prime_premac(params, st, mesh=mesh)
                assert st.h.shape[1] == 19 and (st.premac is None) == (route == "U19")
                b0 = ring_halo.sent_bytes
                for _ in range(PSI_STEPS):
                    st = ferrofluid_step(params, st, mesh=mesh)
                name = route + "_full" * full
                out[f"{name}.stats.bytes"] = (ring_halo.sent_bytes - b0) / PSI_STEPS
                gathered = gather_state(st, mesh)
                out.update({f"{name}.{k}": v for k, v in _flat(to_numpy(gathered)).items()})
        if rank == 0:
            np.savez(pathlib.Path(out_dir) / "psi.npz", **out)
    finally:
        dist.destroy_process_group()


def run_psi(out_dir):
    """:func:`psi_main` on 4 spawned ranks: {"solve.<case>": {key: value},
    route: {field or "stats.bytes": array}} of rank 0."""
    import torch.multiprocessing as mp

    mp.start_processes(psi_main, args=(4, free_port(), str(out_dir)), nprocs=4,
                       start_method="spawn")
    flat = dict(np.load(pathlib.Path(out_dir) / "psi.npz"))
    res = {}
    for key, v in flat.items():
        if key.startswith("solve."):
            _, case, field = key.split(".", 2)
            res.setdefault(f"solve.{case}", {})[field] = v
        else:
            name, field = key.split(".", 1)
            res.setdefault(name, {})[field] = v
    return res
