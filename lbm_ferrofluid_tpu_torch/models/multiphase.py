"""Multiphase solvers on one device: Shan-Chen (one distribution) and
He-Chen-Zhang (two distributions f, g), in 2D and 3D.

Port of ``lbm_ferrofluid_tpu/models/multiphase.py``: ``init_sc_state`` and
``sc_step`` (:44-106), ``init_hcz_state`` (:108) and the HCZ step
``_hcz_step_shared`` (:175-256) without ``jit`` or ``mesh``.  The Shan-Chen
step (demo_2d_LBM_multiphase_SC.py:114-133) is stream, moments and the
density map, bounce-back, then the Shan-Chen force and BGK; it runs plain
PyTorch, as the JAX step runs ``jnp``.  An HCZ step is

1. stream + bounce of f with rho, vel (frozen at obstacles) and density
   (B8b, ``ops/kernels/stream3d.py:stream_bounce_macro``);
2. stream + bounce of g with its raw moments (B8a, ``stream_bounce_moments``);
3. velocity pinning, if the state carries a mask;
4. the contact-angle rewrite of rho (B2, ``ops/kernels/contact3d.py``);
5. the capillary stage: force, dfai, dprho and the velocity and pressure
   recovery (B6, ``ops/kernels/capmac.py``), then pinning again;
6. the HCZ collide of f and g (B9, ``ops/kernels/hcz3d.py``).

The kernels are the 3D route.  The JAX step takes B6 only where gravity is
a concrete value; inside its ``jit`` gravity is traced, so on the TPU it
runs the stencil kernels (B10) instead.  The port has no ``jit`` and its
gravity is always a tuple of floats, so it runs the branch that
``hcz_capillary`` itself picks for a concrete gravity.  In 2D (D2Q9) the
same six stages run the plain ops on any device, with KBC on g when
``params.kbc_type`` asks for it, as the JAX package runs 2D through
``jnp`` only.  With ``mesh`` a state is the rank's part: a 2D state the
rank's block of a y/x mesh, whose ops run on it extended by ghost cells
(``parallel/step2d.py``); a 3D HCZ state a z-slab (:func:`_hcz_step_slab`)
or, on any other split grid, a (z, y, x) block stepping through the
single-device kernels on its extensions (:func:`_hcz_step_blocks`); a 3D
Shan-Chen state a block of its plain ops.  Every entry point runs
on the card unless ``device="cpu"``; ``plain=True`` runs the kernels'
plain PyTorch versions.  f and g may be stored in bfloat16
(``fg_dtype``), on the kernels' bfloat16 forms on the card.
"""

from __future__ import annotations

import torch

from ..ops.collide import contact_angle_boundary, hcz_capillary, hcz_collide, sc_collide
from ..ops.equilibrium import feq, geq
from ..ops.kernels import KERNELS
from ..ops.kernels.capmac import hcz_capillary_gradmac, hcz_capillary_gradmac_plain
from ..ops.kernels.contact3d import contact_angle_3d, contact_angle_3d_plain
from ..ops.kernels.hcz3d import hcz_collide_fused, hcz_collide_fused_plain
from ..ops.kernels.stream3d import (
    stream_bounce_macro,
    stream_bounce_macro_plain,
    stream_bounce_moments,
    stream_bounce_moments_plain,
)
from ..ops.moments import eos_pressure, macro_moments, rho_to_density
from ..ops.stream import bounce_back, stream
from ..ops.stream import stream_bounce_macro as stream_bounce_macro_ops
from ..ops.stream import stream_bounce_moments as stream_bounce_moments_ops
from ..utils.device import check_device, resolve_device
from ..utils.types import KBCType
from .params import SimulationParams
from .state import HCZState

__all__ = ["init_sc_state", "sc_step", "init_hcz_state", "hcz_step"]


def storage_dtype(name: str) -> torch.dtype:
    """The torch dtype of a ``params.fg_dtype``/``h_dtype`` name: float32;
    bfloat16, the JAX package's turbo mode (storage only: every op computes
    in float32 and rounds to nearest even where it stores); float64, on
    the plain versions only (on the CPU or with ``plain=True``), since the
    kernels take float32 and bfloat16 and raise on anything else."""
    if name not in ("float32", "bfloat16", "float64"):
        raise NotImplementedError(
            f"storage dtype {name!r}: f/g/h are stored in float32, bfloat16 or "
            "float64, as in the JAX package (which has no float16 mode)"
        )
    return getattr(torch, name)


def check_supported(params: SimulationParams, f: torch.Tensor, hcz: bool = True,
                    padded: bool = False, batch: int | None = None) -> None:
    """Raise for what the port does not step: a state whose rank or
    distribution count is not ``params.dim``'s lattice, KBC off D2Q9 (the
    JAX package's own ``ValueError``), and (for the HCZ family, ``hcz``)
    the storage dtypes it has no route for and, unless the caller steps
    ``padded`` layouts (the ferrofluid step), ``phys_extent``; a padded
    layout at a batch of more than one, which the JAX package refuses too
    (a batch keeps the 19-channel h, and the channel-form solve does not
    take ``phys_extent``; ``batch``: the whole batch of a rank's part,
    default f's).  Any other batch [B, ...] steps on one device, the B
    elements in each kernel's one launch."""
    lat = params.lattice
    if f.ndim - 2 != params.dim or f.shape[1] != lat.q:
        raise ValueError(
            f"params.dim={params.dim} ({lat.name}) does not match the state: f has shape "
            f"{tuple(f.shape)}"
        )
    if KBCType.is_KBC(params.kbc_type) and lat.q != 9:
        raise ValueError("KBC moment split is defined for D2Q9 only")
    if not hcz:
        return
    storage_dtype(params.fg_dtype)
    storage_dtype(params.h_dtype)
    if params.phys_extent is not None and not padded:
        raise NotImplementedError(
            "phys_extent: only the ferrofluid step steps a padded transposed layout; "
            "the JAX package's hcz_step ignores phys_extent and would tie its ring "
            "fixes to the padded array faces, so step the physical grid instead"
        )
    batch = f.shape[0] if batch is None else batch
    if params.phys_extent is not None and batch != 1:
        raise NotImplementedError(
            f"phys_extent (the padded layout) at a batch of {batch}: a batch keeps the "
            "19-channel h (the scalar carry needs B == 1), and the channel-form solve does not "
            "take phys_extent, so the JAX package refuses it too (phys_extent layouts require "
            "the tau==1 scalar Poisson carry); step each element on its own, or a batch of "
            "the native layout"
        )
    if params.gravity_axis not in range(params.dim):
        raise ValueError(f"gravity_axis={params.gravity_axis} is not an axis")


def check_kernel_grid(f: torch.Tensor, plain: bool, ids=None, grid=None) -> None:
    """Raise on the card without ``plain=True`` where the grid (``f``'s, or
    ``grid``: the whole domain's of a rank's block) has an axis shorter
    than the ``min_axis`` of a kernel wrapper that the step launches
    (``ids``, default all: B2's needs 4, and every HCZ-family step runs
    B2), before any kernel launches.  The plain versions (the CPU,
    ``plain=True``, and every 2D step) step any grid the JAX step steps
    (the JAX package gates only its kernels and steps smaller grids
    through jnp)."""
    if plain or f.device.type != "cuda" or len(f.shape) != 5:
        return
    grid = tuple(f.shape[2:]) if grid is None else tuple(grid)
    short = [f"{kid} {k.wrapper.__name__} (>= {k.wrapper.min_axis})"
             for kid, k in KERNELS.items()
             if (ids is None or kid in ids) and min(grid) < getattr(k.wrapper, "min_axis", 1)]
    if short:
        raise ValueError(f"grid {grid}: the kernels {', '.join(short)} need more cells an "
                         "axis; pass plain=True to step this grid on the plain versions")


def init_sc_state(params: SimulationParams, rho, density, vel, flags, *,
                  device=None) -> HCZState:
    """Shan-Chen initial state from numpy arrays or tensors: f = feq at the
    physical density (JAX :44-62); ``g`` and ``pressure`` are None.  Runs
    on the card unless ``device="cpu"``."""
    dev = resolve_device(device)
    rho = torch.as_tensor(rho, device=dev)
    density = torch.as_tensor(density, device=dev)
    vel = torch.as_tensor(vel, device=dev)
    force = torch.zeros_like(vel)
    f = feq(params.lattice, density, vel, dx=params.dx, dt=params.dt, tau=params.tau,
            force=force)
    return HCZState(f=f, g=None, rho=rho, vel=vel, density=density, pressure=None,
                    force=force, flags=torch.as_tensor(flags, device=dev), step=0)


def on_block(blk, fn, depth=None):
    """``fn`` on this rank's block of a grid split over a mesh
    (``parallel/blocks.py:Blocks.op``: its fields extended by the op's
    ghost cells, its outputs cut back), or ``fn`` itself on one device
    (``blk`` None)."""
    return fn if blk is None else blk.op(fn, depth)


def mesh_blocks(params: SimulationParams, state, mesh, device):
    """The :class:`~..parallel.blocks.Blocks` of a step on ``mesh``, or None
    where each rank steps its part on the single-device route (a batch
    mesh): a 2D state's on y and x (a 2D state on a z mesh raises), a 3D
    state's on z, y and x (the block route, ``parallel/step3d.py:blocks3d``,
    at any number of batch elements a rank).
    Checks ``device`` against the mesh's."""
    from ..parallel import step2d, step3d

    if device is not None and torch.device(device).type != mesh.device.type:
        raise ValueError(f"device={device} does not match the mesh's device {mesh.device}")
    if step3d.dp_dispatch(mesh):
        return None
    if params.dim == 2:
        return step2d.blocks(mesh, state.f)
    return step3d.blocks3d(mesh, state.f)


def sc_step(params: SimulationParams, state: HCZState, *, device=None,
            plain=False, mesh=None) -> HCZState:
    """One Shan-Chen step (JAX ``sc_step_impl`` :65-106), plain PyTorch on
    any device; ``plain`` is accepted for the runner's and the tests'
    uniform calls and changes nothing.  With ``mesh`` the state is this
    rank's part: a 2D state on a y/x mesh, and a 3D state on any split
    grid, steps on its block (``parallel/blocks.py``), bit for bit to one
    device; a batch mesh steps each rank's elements."""
    del plain
    blk = None
    if mesh is not None:
        blk = mesh_blocks(params, state, mesh, device)
        device = mesh.device.type if device is None else device
    check_device(state.f, device)
    check_supported(params, state.f, hcz=False)
    lat = params.lattice
    dx, dt = float(params.dx), float(params.dt)
    f = on_block(blk, stream)(lat, state.f)
    rho, vel = macro_moments(lat, f, state.rho, state.vel, state.flags, dx=dx, dt=dt)
    density = rho_to_density(rho, rho_gas=params.rho_gas, rho_fluid=params.rho_fluid,
                             density_gas=params.density_gas,
                             density_fluid=params.density_fluid)
    f = bounce_back(lat, f, state.flags)
    f, force = on_block(blk, sc_collide)(
        lat, f, rho, density, vel, state.flags, tau=params.tau,
        density_wall=0.5 * (params.density_gas + params.density_fluid), dx=dx, dt=dt)
    return state.replace(f=f, rho=rho, vel=vel, density=density, force=force,
                         step=state.step + 1)


def init_hcz_state(params: SimulationParams, rho, density, vel, flags,
                   vel_pin_mask=None, vel_pin_value=None, *, device=None) -> HCZState:
    """Initial state from numpy arrays or tensors: f = feq at the physical
    density (the reference's init idiom, demo_2d_LBM_multiphase_HCZ.py:114),
    g = geq.  Runs on the card unless ``device="cpu"``."""
    dev = resolve_device(device)
    lat = params.lattice
    rho = torch.as_tensor(rho, device=dev)
    density = torch.as_tensor(density, device=dev)
    vel = torch.as_tensor(vel, device=dev)
    force = torch.zeros_like(vel)
    pressure = eos_pressure(density, dx=params.dx, dt=params.dt)
    f = feq(lat, density, vel, dx=params.dx, dt=params.dt, tau=params.tau, force=force)
    g = geq(lat, rho, density, pressure, f, dx=params.dx, dt=params.dt)
    fg_dt = storage_dtype(params.fg_dtype)

    def optional(x):
        return None if x is None else torch.as_tensor(x, device=dev)

    return HCZState(
        f=f.to(fg_dt), g=g.to(fg_dt), rho=rho, vel=vel, density=density,
        pressure=pressure, force=force, flags=torch.as_tensor(flags, device=dev), step=0,
        vel_pin_mask=optional(vel_pin_mask), vel_pin_value=optional(vel_pin_value),
    )


def _maybe_pin(state, vel):
    """``vel`` with the state's pinned velocities, if it carries a mask
    (on a z-slab mesh the rank's part of the mask and values, which
    ``shard_state`` cuts)."""
    if getattr(state, "vel_pin_mask", None) is not None:
        return torch.where(state.vel_pin_mask, state.vel_pin_value, vel)
    return vel


def _gas(params: SimulationParams) -> dict:
    return dict(rho_gas=float(params.rho_gas), rho_fluid=float(params.rho_fluid),
                density_gas=float(params.density_gas),
                density_fluid=float(params.density_fluid))


def stream_2d(params: SimulationParams, state, blk=None):
    """Stages 1-2 in 2D (plain ops; on the rank's block with ``blk``):
    (f', rho, vel, density, g', m0g, m1g)."""
    lat = params.lattice
    f, rho, vel, density = on_block(blk, stream_bounce_macro_ops)(
        lat, state.f, state.flags, state.rho, state.vel, c=float(params.dx / params.dt),
        **_gas(params))
    g, m0g, m1g = on_block(blk, stream_bounce_moments_ops)(lat, state.g, state.flags)
    return f, rho, vel, density, g, m0g, m1g


def capillary_collide_2d(params: SimulationParams, state, f, g, rho, vel, density, m0g,
                         m1g, H2=None, phi=None, blk=None):
    """Stages 4-6 in 2D (plain ops; JAX ``_hcz_step_shared`` :180-256 and the
    ferrofluid step's unfused tail): the contact angle, the capillary stage
    (with the Kelvin force when ``H2`` and ``phi`` are given), pinning and
    the HCZ collide (KBC on g with ``params.kbc_type``); on the rank's block
    with ``blk``.  Returns (f', g', rho_ca, vel, density, pressure,
    force)."""
    dx, dt = float(params.dx), float(params.dt)
    rho_ca = on_block(blk, contact_angle_boundary)(rho, state.flags,
                                                   float(params.contact_angle))
    # the capillary stage takes g's moments as m0g, m1g (it reads g only
    # where they are None)
    _, vel, density, pressure, force, dfai, dprho = on_block(blk, hcz_capillary)(
        rho, vel, state.flags, density, state.pressure, rho_ca, H2, phi, m0g, m1g,
        kappa=float(params.kappa),
        gravity=torch.as_tensor(params.gravity_vec(), dtype=vel.dtype, device=vel.device),
        dx=dx, dt=dt, **_gas(params),
    )
    vel = _maybe_pin(state, vel)
    f, g = hcz_collide(params.lattice, f, g, rho_ca, vel, density, pressure, state.flags,
                       force, dfai, dprho, tau_f=float(params.tau_f),
                       tau_g=float(params.tau_g), kbc_type=params.kbc_type, dx=dx, dt=dt)
    return f, g, rho_ca, vel, density, pressure, force


def _hcz_step_slab(params: SimulationParams, state, mesh, plain):
    """:func:`hcz_step` on a z-slab mesh (JAX ``_hcz_step_shared`` :175-256
    with ``mesh``, ``ops/collide.py`` :631-690): B8b, B8a, B2, B10b (of
    rho_ca with its density map, as B6's single-device kernel builds the
    Laplacian), B6 in slab form, then B9 on the rank's planes (the collide
    is local); the pins are the rank's part of the state's."""
    from ..parallel import step3d

    check_kernel_grid(state.f, plain)
    dx, dt = float(params.dx), float(params.dt)
    gas = _gas(params)
    collide = hcz_collide_fused_plain if plain else hcz_collide_fused
    f, rho, vel, density = step3d.stream_bounce_macro_sharded(
        state.f, state.flags, state.rho, state.vel, mesh, c=dx / dt, plain=plain, **gas)
    g, m0g, m1g = step3d.stream_bounce_moments_sharded(state.g, state.flags, mesh, plain=plain)
    vel = _maybe_pin(state, vel)
    rho_ca = step3d.contact3d_sharded(rho, state.flags, float(params.contact_angle), mesh,
                                      plain=plain)
    lap = step3d.laplacian_field_sharded(rho_ca, mesh, dx=dx, density_of=tuple(gas.values()),
                                         plain=plain)
    vel, pressure, force, dfai, dprho = step3d.capmac_sharded(
        lap, rho, density, state.pressure, rho_ca, None, None, state.flags, m0g, m1g, vel,
        mesh, kappa=float(params.kappa),
        gravity=tuple(float(v) for v in params.gravity_vec().reshape(-1)), dx=dx, dt=dt,
        plain=plain, **gas,
    )
    density = rho_to_density(rho_ca, **gas)
    vel = _maybe_pin(state, vel)
    f, g = collide(f, g, rho_ca, vel, density, pressure, state.flags, force, dfai, dprho,
                   tau_f=float(params.tau_f), tau_g=float(params.tau_g), dx=dx, dt=dt)
    return state.replace(f=f, g=g, rho=rho_ca, vel=vel, density=density,
                         pressure=pressure, force=force, step=state.step + 1)


def _hcz_step_blocks(params: SimulationParams, state, mesh, plain):
    """:func:`hcz_step` on the block route (a 3D state on a split grid the
    slab forms do not take, ``parallel/step3d.py:on_slabs``): B8b, B8a, B2
    and B6 each on the rank's block extended under its edge rule
    (``parallel/blocks.py:HALOS``), the pins and B9 on the block, as one
    device runs them (JAX ``_hcz_step_shared`` :175-256 under GSPMD)."""
    from ..parallel import step3d

    blk = step3d.blocks3d(mesh, state.f)
    step3d.check_block_grid(blk, state.f, plain)
    dx, dt = float(params.dx), float(params.dt)
    gas = _gas(params)
    macro = stream_bounce_macro_plain if plain else stream_bounce_macro
    moments = stream_bounce_moments_plain if plain else stream_bounce_moments
    surgery = contact_angle_3d_plain if plain else contact_angle_3d
    capillary = hcz_capillary_gradmac_plain if plain else hcz_capillary_gradmac
    collide = hcz_collide_fused_plain if plain else hcz_collide_fused
    # f and g in one exchange a side and axis
    blk.extend([state.f, state.g], 1)
    f, rho, vel, density = blk.op(macro)(state.f, state.flags, state.rho, state.vel, c=dx / dt,
                                         **gas)
    g, m0g, m1g = blk.op(moments)(state.g, state.flags)
    vel = _maybe_pin(state, vel)
    # B6's stencil fields of this step's macros in one exchange
    blk.extend([rho, density, state.pressure], 3)
    rho_ca = blk.op(surgery)(rho, state.flags, float(params.contact_angle))
    vel, pressure, force, dfai, dprho = blk.op(capillary)(
        rho, density, state.pressure, rho_ca, None, None, state.flags, m0g, m1g, vel,
        kappa=float(params.kappa),
        gravity=tuple(float(v) for v in params.gravity_vec().reshape(-1)), dx=dx, dt=dt, **gas,
    )
    density = rho_to_density(rho_ca, **gas)
    vel = _maybe_pin(state, vel)
    f, g = collide(f, g, rho_ca, vel, density, pressure, state.flags, force, dfai, dprho,
                   tau_f=float(params.tau_f), tau_g=float(params.tau_g), dx=dx, dt=dt)
    return state.replace(f=f, g=g, rho=rho_ca, vel=vel, density=density,
                         pressure=pressure, force=force, step=state.step + 1)


def hcz_step(params: SimulationParams, state: HCZState, *, device=None,
             plain=False, mesh=None) -> HCZState:
    """One HCZ step.  ``plain=True`` runs the kernels' plain PyTorch
    versions (on any device) instead of the kernels; a 2D step runs the
    plain ops and launches no kernel.  A batch [B, ...] steps in one launch
    a kernel (B8b, B8a, B2, B6, B9).  With ``mesh`` the state is this
    rank's part (``parallel/sharding.py``): on a batch mesh (nz == 1) each
    rank steps its own batch elements; a 3D state on z-slabs of 4 or more
    planes (``nz > 1``, or ``slab=True``) at one element a rank steps on
    the kernels' slab forms (:func:`_hcz_step_slab`), on any other split
    grid, or at more elements a rank, on its (z, y, x) block
    (:func:`_hcz_step_blocks`, each launch taking the rank's batch), and
    on a y/x mesh a 2D state steps on its block (``parallel/step2d.py``),
    each bit for bit to one device."""
    blk = None
    if mesh is not None:
        from ..parallel import step3d

        if params.dim == 2:
            blk = mesh_blocks(params, state, mesh, device)
        device = mesh.device.type if device is None else device
        if params.dim != 2 and not step3d.dp_dispatch(mesh):
            check_device(state.f, device)
            check_supported(params, state.f)
            if step3d.on_slabs(mesh, state.f.shape):
                return _hcz_step_slab(params, state, mesh, plain)
            return _hcz_step_blocks(params, state, mesh, plain)
    check_device(state.f, device)
    check_supported(params, state.f)
    if params.dim == 2:
        f, rho, vel, density, g, m0g, m1g = stream_2d(params, state, blk)
        vel = _maybe_pin(state, vel)
        f, g, rho, vel, density, pressure, force = capillary_collide_2d(
            params, state, f, g, rho, vel, density, m0g, m1g, blk=blk)
        return state.replace(f=f, g=g, rho=rho, vel=vel, density=density,
                             pressure=pressure, force=force, step=state.step + 1)
    check_kernel_grid(state.f, plain)
    dx, dt = float(params.dx), float(params.dt)
    gas = _gas(params)
    macro = stream_bounce_macro_plain if plain else stream_bounce_macro
    moments = stream_bounce_moments_plain if plain else stream_bounce_moments
    surgery = contact_angle_3d_plain if plain else contact_angle_3d
    capillary = hcz_capillary_gradmac_plain if plain else hcz_capillary_gradmac
    collide = hcz_collide_fused_plain if plain else hcz_collide_fused

    f, rho, vel, density = macro(state.f, state.flags, state.rho, state.vel, c=dx / dt,
                                 **gas)
    g, m0g, m1g = moments(state.g, state.flags)
    vel = _maybe_pin(state, vel)
    rho_ca = surgery(rho, state.flags, float(params.contact_angle))
    vel, pressure, force, dfai, dprho = capillary(
        rho, density, state.pressure, rho_ca, None, None, state.flags, m0g, m1g, vel,
        kappa=float(params.kappa),
        gravity=tuple(float(v) for v in params.gravity_vec().reshape(-1)),
        dx=dx, dt=dt, **gas,
    )
    density = rho_to_density(rho_ca, **gas)
    vel = _maybe_pin(state, vel)
    f, g = collide(f, g, rho_ca, vel, density, pressure, state.flags, force, dfai, dprho,
                   tau_f=float(params.tau_f), tau_g=float(params.tau_g), dx=dx, dt=dt)
    return state.replace(f=f, g=g, rho=rho_ca, vel=vel, density=density,
                         pressure=pressure, force=force, step=state.step + 1)
