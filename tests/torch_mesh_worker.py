"""Ranks of the port's meshed step, for tests/test_torch_parallel.py.

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


def run_ranks(world, out_dir, **job):
    """Spawn ``world`` ranks of :func:`rank_main` on a free port and wait
    for them (a failure or a hang of any rank raises)."""
    import torch.multiprocessing as mp

    mp.start_processes(rank_main, args=(world, free_port(), *(job[k] for k in (
        "shape", "slab", "poisson_iters", "batch", "steps")), str(out_dir),
        job.get("checkpoint", False), job.get("route", "Z")), nprocs=world,
        start_method="spawn")
    return dict(np.load(pathlib.Path(out_dir) / "steps.npz"))
