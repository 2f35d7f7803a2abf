"""Single-phase solver (BGK or entropic KBC), on one device.

Port of ``lbm_ferrofluid_tpu/models/singlephase.py`` (:28-91).  A step
follows the reference driver (demo_2d_LBM.py:101-121): stream, bounce-back
and the raw moments of f (``stream_bounce_moments``), rho and vel frozen
on OBSTACLE cells, then the BGK or (D2Q9 only) KBC collision with the
state's constant body force.

In 3D (D3Q19) the stream is the B8a kernel on the card
(``ops/kernels/stream3d.py:stream_bounce_moments``, the TPU kernel the JAX
step runs there); ``plain=True`` and CPU tensors run its plain version.  In
2D every op is plain PyTorch on any device, as the JAX package runs 2D only
through ``jnp``.  With ``mesh`` a 2D state steps on its block of a y/x
mesh and a 3D state on its (z, y, x) block of any split grid, at any
number of batch elements a rank, B8a on the block extended by one wrapped
cell (``parallel/blocks.py``).  Every entry
point runs on the card unless ``device="cpu"``.
"""

from __future__ import annotations

import torch

from ..ops.collide import bgk_collide, kbc_collide
from ..ops.equilibrium import feq
from ..ops.kernels.stream3d import stream_bounce_moments as b8a
from ..ops.kernels.stream3d import stream_bounce_moments_plain as b8a_plain
from ..ops.stream import stream_bounce_moments
from ..utils.device import check_device, resolve_device
from ..utils.types import CellType, KBCType
from .multiphase import check_kernel_grid, check_supported, mesh_blocks, on_block
from .params import SimulationParams
from .state import SinglePhaseState

__all__ = ["init_state", "step"]


def init_state(params: SimulationParams, rho, vel, flags, force=None, *,
               device=None) -> SinglePhaseState:
    """f = feq(rho, vel, force), as every reference demo seeds it, from
    numpy arrays or tensors.  Runs on the card unless ``device="cpu"``."""
    dev = resolve_device(device)
    rho = torch.as_tensor(rho, device=dev)
    vel = torch.as_tensor(vel, device=dev)
    force = torch.zeros_like(vel) if force is None else torch.as_tensor(force, device=dev)
    f = feq(params.lattice, rho, vel, dx=params.dx, dt=params.dt, tau=params.tau, force=force)
    return SinglePhaseState(f=f, rho=rho, vel=vel, force=force,
                            flags=torch.as_tensor(flags, device=dev), step=0)


def step(params: SimulationParams, state: SinglePhaseState, *, device=None,
         plain=False, mesh=None) -> SinglePhaseState:
    """One single-phase step.  3D launches B8a once on the card unless
    ``plain=True``; 2D launches no kernel of the port.  With ``mesh`` the
    state is this rank's part: a 2D state on a y/x mesh and a 3D state on
    any split grid step on their block (``parallel/blocks.py``), bit for bit
    to one device; a batch mesh steps each rank's elements."""
    blk = None
    if mesh is not None:
        blk = mesh_blocks(params, state, mesh, device)
        device = mesh.device.type if device is None else device
    check_device(state.f, device)
    check_supported(params, state.f, hcz=False)
    lat = params.lattice
    dx, dt = float(params.dx), float(params.dt)
    if lat.dim == 3:
        check_kernel_grid(state.f, plain, ("B8a",))
        if blk is not None:
            from ..parallel.step3d import check_block_grid

            check_block_grid(blk, state.f, plain, ("B8a",))
        f, m0, m1 = on_block(blk, b8a_plain if plain else b8a)(state.f, state.flags)
    else:
        f, m0, m1 = on_block(blk, stream_bounce_moments)(lat, state.f, state.flags)
    is_obs = state.flags == int(CellType.OBSTACLE)
    rho = torch.where(is_obs, state.rho, m0)
    vel = torch.where(is_obs, state.vel, m1 * ((dx / dt) / rho))
    if KBCType.is_KBC(params.kbc_type):
        f = kbc_collide(lat, f, rho, vel, state.flags, state.force, tau=params.tau,
                        kbc_type=params.kbc_type, dx=dx, dt=dt)
    else:
        f = bgk_collide(lat, f, rho, vel, state.flags, state.force, tau=params.tau, dx=dx,
                        dt=dt)
    return state.replace(f=f, rho=rho, vel=vel, step=state.step + 1)
