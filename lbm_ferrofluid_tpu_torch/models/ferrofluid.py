"""Ferrofluid solver: HCZ multiphase + magnetic Poisson solve + Kelvin force,
on one device.

Port of ``lbm_ferrofluid_tpu/models/ferrofluid.py:ferrofluid_step_impl``
(:280-766) on one device.  The step steps the state it is given and never
primes; ``state.premac`` selects one of three routes:

* **6 leaves, the capillogue steady state** (after :func:`prime_premac`,
  which runs the prologue B4 once): this step's macros and Poisson source
  from ``premac``; the magnetic solve; the contact-angle rewrite of rho (B2,
  ``ops/kernels/contact3d.py``); the capillogue, i.e. capillary stage, HCZ
  collide of f and g and the next step's macros and source at the magnetic
  tau (B3, ``ops/kernels/capillogue.py``).  Returns a 6-leaf premac with
  ``phi``, ``force`` and ``H_ext`` None.
* **5 leaves, the epilogue steady state** (a state the JAX package primed
  where its capillogue does not fit, handed over with ``from_numpy``): the
  macros from ``premac``; phi from the density and the Poisson source from
  phi; the solve; B2; the capillary stage with H2 and phi (B6,
  ``ops/kernels/capmac.py``); the epilogue with the next step's macros
  (B5 with ``emit_mac``, ``ops/kernels/fused_step.py``).  Returns a 5-leaf
  premac with ``phi`` and ``force`` as tensors.
* **None, the un-carried step**: the prologue (B4) on ``f``/``g``, then as
  the 5-leaf route with B5 without ``emit_mac``.  Returns ``premac`` None,
  with ``phi``, ``force`` and ``H_ext`` kept.

An out-of-plane field (``h_ext_axis=2``) takes the JAX step's other
capillogue form (:549-571 there): :func:`prime_premac` makes a 5-leaf
premac and keeps ``phi``, ``force`` and ``H_ext``; each step computes the
Poisson source from phi again, and B3 runs in its box form (force written,
no source emitted) where the in-plane field's 6-leaf route runs.  The padded
transposed layout (``params.phys_extent``, ``scenes.rosensweig_3d_tpu``:
physical (z, y, x) stored as array (y, z, x), the walled axes padded with
OBSTACLE cells, gravity and field along array z) is such a state: its
magnetic solve needs the scalar carry and runs B1's psi form on the padded
arrays, with H2 composed on the physical box (:func:`_h2_box`, B1's H2
launch on the box), the contact angle runs on the box in its physical
orientation (:func:`_contact_angle_box`, B2), B3 puts its in-plane ring
fixes at the box faces (``bounds``), and the un-carried step runs the plain
capillary stage on the box (:func:`_hcz_capillary_box`) before B5.

The magnetic solve runs in the form ``state.h`` has (``h.shape[1]``):
2 channels, the tau == 1 scalar collapse with in-kernel H2 (B1,
``ops/kernels/scalar_poisson.py``), into which :func:`prime_premac` converts
h when ``_scalar_physics_ok`` holds; 19 channels, the Chai Poisson-LBM on
the channel distribution at any tau (``ops/magnetic.py:solve_H_int``: the
sweeps B11b, ``ops/kernels/poisson.py``, then the gradient of psi B10a,
``ops/kernels/stencil3d.py``), as ``init_ferrofluid_state`` makes h.

In 2D (D2Q9) the step is the JAX step's unfused branch on plain PyTorch
on any device, as the JAX package runs 2D only through ``jnp``: stream and
macros of f and g, phi and the Poisson source, the solve in the form
``state.h`` has (9 channels, or the scalar carry with the exact-order
sweeps, into which :func:`prime_premac` converts h and which is its only
2D priming), then the shared 2D HCZ stages with H2 and phi
(``models/multiphase.py:capillary_collide_2d``, KBC on g with
``params.kbc_type``).  A 2D step launches no kernel and carries no premac.

With ``mesh`` (``parallel/mesh.py``: this rank's place among the ranks of a
mesh over ``batch``, ``z``, ``y`` and ``x``) :func:`prime_premac` and
:func:`ferrofluid_step` take and return this rank's part of the state
(``parallel/sharding.py``), as the JAX step's ``mesh=`` does (:318-358,
:419-466, :583-735, :979-1026 there).  A 3D state takes one of two routes
on a split grid (``parallel/step3d.py:on_slabs``):

* **z-slabs** (z and batch axes only, or ``slab=True``; one batch element a
  rank, ROADMAP A12 slice 7b; slabs of 4 or more planes): every 3D route runs on the kernels'
  slab forms: the capillogue steady state (6 leaves: the solve, B2, B3);
  the epilogue steady state (5 leaves), which is also what an out-of-plane
  field (``h_ext_axis=2``) primes to, and the un-carried step (premac None:
  B4 each step), each through the solve, B2, B10b (the Laplacian of
  density(rho_ca), the density map taken as B6's single-device kernel
  takes it, so the routes equal the single-device ones bit for bit), B6
  with that Laplacian as an input, and B5 (with ``emit_mac`` on 5 leaves),
  as the JAX meshed step takes the capillogue only for a 6-leaf premac
  (:588-592 there).  The solve takes the form of ``state.h``: the scalar
  carry (B1's slab rounds) or the 19-channel h (``ops/magnetic.py:
  solve_H_int`` with ``mesh``: B11b's slab rounds, the substitution,
  B10a), which priming keeps where the collapse does not apply.  An
  out-of-plane field's Poisson source reads phi a plane across the slab's
  faces (``step3d.poisson_rhs_sharded``).
* **blocks** (any other split grid: a y or x axis, slabs of 2 or 3
  planes, or two or more batch elements a rank on any split grid): the
  un-carried route, whose every
  launch has one edge rule, as the JAX package's meshed priming selects
  off its slab gates (:979-995 there: the scalar carry where the collapse
  applies, no premac).  :func:`prime_premac` converts h across the block's
  faces (the obstacle check over every rank) and returns ``premac=None``;
  each step runs B4, the Poisson source, the solve (the scalar carry: B1's
  passes in rounds, then its H2 launch; the 19-channel h: B11b's passes in
  rounds, then the substitution and B10a, the psi route), B2, B6 and B5,
  every kernel the single-device one on the rank's block extended by ghost
  cells under its edge rule (``parallel/blocks.py``), bit for bit to one
  device's steps on the same route.  A rank part of B_local > 1 elements
  steps as one device steps a batch: priming leaves it as it is (h in 19
  channels), and each launch takes the rank's whole batch (B10a on the
  psi route by its batch form).  A state that carries a premac there
  raises, at priming and at the step alike: prime it on the mesh.

A padded layout (``phys_extent``) takes the same two routes, as the JAX
meshed step takes its box stages on any mesh (:422-438, :641-650 there):
priming leaves the 5-leaf premac on slabs and none on blocks, with the
scalar h; each step solves with B1's psi passes in the rounds of the
rank's blocks (z-only on slabs), then composes H2 (B1's H2 launch), runs
B2 and the plain capillary stage on the rank's part of the box
(:func:`_on_box`: the box's intersection with the block extended by 3
cells, in global coordinates, so that the box faces keep their rules),
then B5 (its slab form with ``emit_mac`` on slabs).

Priming and the step run the same gates (:func:`_slab_gates`,
:func:`_block_gates`; ROADMAP C7).  A 2D state on a mesh
with ``y`` and ``x`` axes steps on the rank's block (``parallel/step2d.py``):
the same plain ops on the block extended by ghost cells, the solve's
sweeps in rounds, priming's scalar conversion across the block's faces,
bit for bit to one device; a 2D state on a z mesh raises.  On a batch mesh
each rank steps its own batch elements on the single-device route its
state selects.

A batch of more than one element ([B, ...]; a batch mesh's rank part too)
steps as the JAX package steps it: :func:`prime_premac` returns it as it
is, so in 3D it steps un-carried on its 19-channel h (B4, B11b's passes
with B7's trailing stage, B2, B6, B5), each kernel one launch for the whole
batch; in 2D on the plain ops.  The scalar carry and the 6-leaf premac at
B > 1 (B1 and B3 have no batch form, ROADMAP A12 slice 8) raise, and so
does the padded layout at B > 1, as the JAX package refuses it: a batch
keeps the 19-channel h, whose solve does not take ``phys_extent``.  More
than one element a rank on a split grid steps on the block route.

Every entry point runs on the card unless ``device="cpu"`` is passed, and
the kernels run unless ``plain=True`` is passed, which selects their plain
PyTorch versions.  bfloat16 storage of f, g and h (``fg_dtype``/``h_dtype``,
the JAX package's turbo mode) runs on every route, on the kernels'
bfloat16 forms on the card; the scalar carry stays float32.  float64
storage runs on the plain versions only.
Configurations outside the port raise ``NotImplementedError`` naming their
ROADMAP item, or what they lack; nothing falls back.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.collide import hcz_capillary
from ..ops.equilibrium import feq, geq
from ..ops.kernels.capillogue import lbm_capillogue, lbm_capillogue_plain
from ..ops.kernels.capmac import hcz_capillary_gradmac, hcz_capillary_gradmac_plain
from ..ops.kernels.contact3d import contact_angle_3d, contact_angle_3d_plain
from ..ops.kernels.fused_step import (
    lbm_epilogue,
    lbm_epilogue_plain,
    lbm_prologue,
    lbm_prologue_plain,
)
from ..ops.kernels.scalar_poisson import h2_from_psi_plain, scalar_h2
from ..ops.magnetic import (
    poisson_rhs_scaled,
    solve_H_int,
    solve_H_int_scalar,
    solve_psi_scalar,
)
from ..ops.moments import eos_pressure, phi_from_density, rho_to_density
from ..ops.scalar_poisson import make_cmask, s_prev_from_h, scalar_from_h
from ..ops.stencils import staggered
from ..utils.device import check_device, resolve_device
from ..utils.types import CellType
from .multiphase import (
    capillary_collide_2d,
    check_kernel_grid,
    check_supported,
    mesh_blocks,
    on_block,
    storage_dtype,
    stream_2d,
)
from .params import SimulationParams
from .state import FerrofluidState

__all__ = [
    "init_ferrofluid_state", "ferrofluid_step", "make_H_ext", "prime_premac",
    "phi_field",
]


def phi_field(params: SimulationParams, state):
    """The order parameter phi = -(2 (density - rho_g)/(rho_l - rho_g) - 1)
    (demo_3d_LBM_Rosensweig_instability.py:171), derived from the current
    density when the carried steady state does not store it."""
    if state.phi is not None:
        return state.phi
    return phi_from_density(state.density, params.density_gas, params.density_fluid)


def make_H_ext(params: SimulationParams, res, batch=1, dtype=torch.float32,
               device=None):
    """Constant external field of magnitude mag_strength along
    params.h_ext_axis, plus its MAC staggering."""
    H = torch.zeros((batch, params.dim, *res), dtype=dtype,
                    device=resolve_device(device))
    H[:, params.h_ext_axis] = params.mag_strength
    return H, tuple(staggered(H))


def validate_mag_shell(params: SimulationParams, magnetic_flags, blk=None) -> None:
    """Check the ``mag_flags_shell`` declaration against the flags: the
    magnetic obstacles must lie in the x-edge columns and z-edge planes;
    with ``blk`` (a rank's block) those of the whole domain, on every
    rank."""
    if not (params.mag_flags_shell and params.dim == 3):
        return
    obs = magnetic_flags == int(CellType.OBSTACLE)
    if blk is not None:
        from ..parallel.blocks import any_rank, interior

        bad = any_rank(blk, interior(blk, obs, dims=(2, 4)))
    else:
        bad = bool(obs[..., 1:-1, :, 1:-1].any())
    if bad:
        raise ValueError(
            "params.mag_flags_shell=True, but magnetic_flags has OBSTACLE "
            "cells outside the x-edge columns / z-edge planes shell; unset "
            "mag_flags_shell for this geometry"
        )


def init_ferrofluid_state(params: SimulationParams, rho, density, vel, flags,
                          magnetic_flags, *, device=None):
    """Initial state from numpy arrays or tensors: f = feq, g = geq at the
    given macros, h = 0.  Runs on the card unless ``device="cpu"``."""
    dev = resolve_device(device)
    lat = params.lattice
    rho = torch.as_tensor(rho, device=dev)
    density = torch.as_tensor(density, device=dev)
    vel = torch.as_tensor(vel, device=dev)
    flags = torch.as_tensor(flags, device=dev)
    magnetic_flags = torch.as_tensor(magnetic_flags, device=dev)
    pressure = eos_pressure(density, dx=params.dx, dt=params.dt)
    f = feq(lat, density, vel, dx=params.dx, dt=params.dt)
    g = geq(lat, rho, density, pressure, f, dx=params.dx, dt=params.dt)
    fg_dt = storage_dtype(params.fg_dtype)
    f, g = f.to(fg_dt), g.to(fg_dt)
    h = torch.zeros(f.shape, dtype=storage_dtype(params.h_dtype), device=dev)
    validate_mag_shell(params, magnetic_flags)
    H_ext, H_ext_mac = make_H_ext(
        params, tuple(rho.shape[2:]), batch=rho.shape[0], dtype=rho.dtype, device=dev,
    )
    return FerrofluidState(
        f=f, g=g, h=h, rho=rho, vel=vel, density=density, pressure=pressure,
        force=torch.zeros_like(vel), phi=torch.zeros_like(rho), flags=flags,
        magnetic_flags=magnetic_flags, H_ext=H_ext, H_ext_mac=H_ext_mac, step=0,
    )


def _mag_boundary_only(magnetic_flags, phys_extent=None) -> bool:
    """Every magnetic OBSTACLE cell lies on the domain's outermost ring:
    the physics precondition of the tau == 1 scalar collapse.  On a padded
    layout (``phys_extent``) every cell outside the physical box must be an
    OBSTACLE and the box's interior free of them (JAX :769-805)."""
    obs = int(CellType.OBSTACLE)
    if phys_extent is not None:
        pz, py, px = phys_extent
        if ((magnetic_flags[..., pz:, :, :] != obs).any()
                or (magnetic_flags[..., :, py:, :] != obs).any()
                or (magnetic_flags[..., :, :, px:] != obs).any()):
            return False
        return not bool((magnetic_flags[..., 1:pz - 1, 1:py - 1, 1:px - 1] == obs).any())
    interior = magnetic_flags[(Ellipsis,) + (slice(1, -1),) * (magnetic_flags.ndim - 2)]
    return not bool((interior == obs).any())


def _scalar_physics_ok(params: SimulationParams, magnetic_flags, blk=None) -> bool:
    """Preconditions of the tau == 1 scalar Poisson collapse (the JAX
    package's ``_scalar_physics_ok`` :808-829): tau == 1, ``scalar_carry``,
    h not stored in float64 (the carry is float32), an axis-aligned field,
    and magnetic obstacles on the boundary ring only (the declared
    ``mag_flags_shell`` counts only without ``phys_extent``); with ``blk``
    (a rank's block of a grid split over a mesh) the ring, or the padded
    layout's box and pad, is the whole domain's, checked on every rank."""
    if blk is not None:
        from ..parallel.blocks import mag_boundary_only

        boundary_only = mag_boundary_only(blk, magnetic_flags, params.phys_extent)
    else:
        boundary_only = _mag_boundary_only(magnetic_flags, params.phys_extent)
    return (
        params.scalar_carry
        and float(params.tau) == 1.0
        and params.h_dtype != "float64"
        and params.h_ext_axis in range(params.dim)
        and ((params.mag_flags_shell and params.phys_extent is None) or boundary_only)
    )


def _check_supported(params: SimulationParams, state, mesh=None) -> None:
    """Raise for configurations the port does not step.  A padded layout
    needs the orientation ``scenes.rosensweig_3d_tpu`` builds: gravity and
    the field along array z (the JAX package does not check this; its
    in-plane source emission would then run on a padded layout).  With a
    3D ``mesh`` the padded layout's checks read the whole domain's batch
    and extent, not the rank's part."""
    shape = tuple(state.f.shape)
    if mesh is not None and params.dim == 3:
        from ..parallel.step3d import global_shape

        shape = global_shape(shape, mesh)
    check_supported(params, state.f, padded=True, batch=shape[0])
    if params.h_ext_axis not in range(params.dim):
        raise ValueError(f"h_ext_axis={params.h_ext_axis} is not an axis")
    if params.dim == 3 and state.f.shape[0] != 1 and (
            state.h.shape[1] == 2 or (state.premac is not None and len(state.premac) == 6)):
        raise NotImplementedError(
            f"a batch of {state.f.shape[0]} with the scalar carry or the 6-leaf capillogue "
            "premac is not ported (ROADMAP A12 slice 8: B1's and B3's batch forms); a batch "
            "steps un-carried on the 19-channel h, as the JAX package steps it (prime_premac "
            "leaves a batch as it is)")
    if params.phys_extent is None:
        return
    if params.dim != 3 or params.gravity_axis != 2 or params.h_ext_axis != 2:
        raise NotImplementedError(
            f"phys_extent={params.phys_extent} (the padded transposed layout) needs dim=3 "
            "and gravity and the field along array z: gravity_axis=2 and h_ext_axis=2, got "
            f"dim={params.dim}, gravity_axis={params.gravity_axis}, "
            f"h_ext_axis={params.h_ext_axis} (scenes.rosensweig_3d_tpu builds it)"
        )
    if len(params.phys_extent) != 3 or not all(
            3 <= b <= n for b, n in zip(params.phys_extent, shape[2:])):
        raise ValueError(f"phys_extent={params.phys_extent} is not a box of 3 or more cells "
                         f"an axis inside the array {shape[2:]}")


def _hext_static(params: SimulationParams):
    return tuple(
        float(params.mag_strength) if d == params.h_ext_axis else 0.0
        for d in range(params.dim)
    )


def _phys(x, vector=False):
    """``x`` with (z_a, y_a) swapped to the physical (z, y) and, for a
    vector, its channels permuted (0, 2, 1); its own inverse."""
    x = x.transpose(-3, -2)
    return (x[:, (0, 2, 1)] if vector else x).contiguous()


#: the ghost depth of the box ops on a rank (``parallel/blocks.py:HALOS``'
#: clamp depth of B2, B1's H2 launch and the capillary stage)
BOX_DEPTH = 3


def _on_box(params: SimulationParams, fn, fields, vectors=(), blk=None):
    """Run ``fn`` on the physical box of a padded layout, in physical
    orientation (the ``fields`` whose index is in ``vectors`` permuted),
    and return (its output, ``put``): ``put(base, y, vector=False)`` is a
    copy of ``base`` with its box cells from ``y``, an output of ``fn``
    (past the box ``base``'s values stay).  ``fn`` applies its face rules
    at the faces of what it is given.  On one device that is the box.  On
    a rank's block (``blk``) it is the box's intersection with the block
    extended by :data:`BOX_DEPTH` cells under the clamp rule, in global
    coordinates: each face there is a box face, or an inner face whose
    wrong cells lie in the ghosts that ``put`` drops.  A rank with no box
    cell runs nothing (output None, ``put`` copies ``base``), after taking
    part in the exchanges."""
    if blk is None:
        ext, start = list(fields), (0, 0, 0)
        block = [(0, n) for n in fields[0].shape[2:]]
    else:
        from ..parallel.blocks import CLAMP

        ext = blk.extend(list(fields), BOX_DEPTH, CLAMP)
        start = blk.origin(BOX_DEPTH, CLAMP)
        block = [(c0, n) for _, n, c0, _ in blk.axes.values()]
    # the box starts at the domain's first cell: it ends in the extension
    # at min(extent, p - start) and in the block at min(n, p - c0)
    ends = [min(n, p - s) for n, p, s in zip(ext[0].shape[2:], params.phys_extent, start)]
    held = [min(n, p - c0) for (c0, n), p in zip(block, params.phys_extent)]
    if min(held) <= 0:
        # a new tensor all the same: the exchanges key a field by its
        # identity, so that each rank extends the same fields
        return None, lambda base, y, vector=False: base.clone()
    out = fn(*(_phys(x[(Ellipsis, *(slice(0, e) for e in ends))], i in vectors)
               for i, x in enumerate(ext)))
    src = (Ellipsis, *(slice(c0 - s, c0 - s + m) for (c0, _), s, m in zip(block, start, held)))
    dst = (Ellipsis, *(slice(0, m) for m in held))

    def put(base, y, vector=False):
        base = base.clone()
        base[dst] = _phys(y, vector)[src]
        return base

    return out, put


def _contact_angle(params: SimulationParams, rho, flags, plain, blk=None):
    """The contact-angle rewrite of rho (B2).  On a padded layout it runs on
    the physical box in its physical orientation, as the reference's
    surgery at its array faces, whose corner rule depends on the order of
    the faces (JAX ``_contact_angle_box`` :162-182); cells past the box
    keep rho.  ``blk``: on a rank's block (:func:`_on_box`)."""
    surgery = contact_angle_3d_plain if plain else contact_angle_3d
    angle = float(params.contact_angle)
    if params.phys_extent is None:
        return surgery(rho, flags, angle)
    rho_ca, put = _on_box(params, lambda r, fl: surgery(r, fl, angle), (rho, flags), blk=blk)
    return put(rho, rho_ca)


def _h2_box(params: SimulationParams, psi, cmask, plain, blk=None):
    """H2 = |H_ext + H_int|^2 composed on the physical box of a padded
    layout, zero past it (JAX ``_h2_box`` :185-206): the box of psi in
    physical orientation, the gradient's obstacle substitution and output
    replicate at its faces, the field's channels permuted (0, 2, 1); B1's
    H2 launch on the box copy (``cmask < 0`` marks the same cells as the
    box's magnetic obstacles).  ``blk``: on a rank's block, psi exact
    :data:`BOX_DEPTH` cells past it (:func:`_on_box`)."""
    h = _hext_static(params)
    compose = h2_from_psi_plain if plain else scalar_h2
    H2, put = _on_box(params, lambda p, c: compose(p, c, float(params.dx), (h[0], h[2], h[1])),
                      (psi, cmask), blk=blk)
    return put(torch.zeros_like(psi), H2)


def _hcz_capillary_box(params: SimulationParams, rho, rho_ca, vel, flags, density, pressure,
                       H2, phi, m0g, m1g, blk=None):
    """The plain capillary stage on the physical box of a padded layout
    (JAX ``_hcz_capillary_box`` :209-260): the box in physical orientation,
    vectors permuted (0, 2, 1), gravity along physical y, the ring fixes at
    its faces.  Returns (vel, density, pressure, force, dfai, dprho): past
    the box vel, density and pressure keep their values, and force, dfai
    and dprho are zero (nothing reads them there: every fluid cell's
    stencil stays inside the box).  ``blk``: on a rank's block
    (:func:`_on_box`)."""
    # gravity rounded to float32 as params.gravity_vec() rounds it (JAX :230-231)
    grav = torch.zeros((1, 3, 1, 1, 1), dtype=vel.dtype, device=vel.device)
    grav[0, 1] = float(np.float32(-params.gravity))

    def stage(*xs):
        return hcz_capillary(
            *xs, kappa=params.kappa, gravity=grav, rho_gas=params.rho_gas,
            rho_fluid=params.rho_fluid, density_gas=params.density_gas,
            density_fluid=params.density_fluid, dx=params.dx, dt=params.dt)[1:]

    out, put = _on_box(params, stage, (rho, vel, flags, density, pressure, rho_ca, H2, phi,
                                       m0g, m1g), vectors=(1, 9), blk=blk)
    vel_p, den_p, pres_p, force_p, dfai_p, dprho_p = out or (None,) * 6
    zeros = torch.zeros_like(vel)
    return (put(vel, vel_p, True), put(density, den_p), put(pressure, pres_p),
            put(zeros, force_p, True), put(zeros, dfai_p, True), put(zeros, dprho_p, True))


def _scalar_convert(params: SimulationParams, state, blk=None):
    """(h, cmask) that the step carries: the scalar pair (s, s_prev) and its
    cmask from a canonical channel h (zeros at init, post-collision h of any
    tau == 1 run) when the collapse applies, else the channel h as it is
    (JAX ``_prime_steady`` :926-929).  The carry is float32 whatever
    ``h_dtype`` stores the channel h in (JAX ``_scalar_convert`` :889-891).
    A batch of more than one keeps its channel h, in 2D too (JAX
    ``_scalar_carry_ok`` :832-842).  With ``blk`` (a rank's block of a grid
    split over a mesh) the rank's block: the obstacle check over the whole
    domain, the wall channels read across the block's faces."""
    if (state.h.shape[1] == 2 or state.h.shape[0] != 1
            or not _scalar_physics_ok(params, state.magnetic_flags, blk)):
        return state.h, state.cmask
    s = scalar_from_h(state.h, state.magnetic_flags)
    sp = on_block(blk, s_prev_from_h)(state.h, state.magnetic_flags)
    return (torch.cat([s, sp], dim=1).to(torch.float32),
            on_block(blk, make_cmask)(state.magnetic_flags))


def _on_mesh(state, mesh, device):
    """The device a meshed call runs on: the mesh's, which the state and
    ``device`` (if given) must agree with."""
    dev = mesh.device if device is None else resolve_device(device)
    if dev.type != mesh.device.type:
        raise ValueError(f"device={dev} does not match the mesh's device {mesh.device}")
    return dev.type


def _slab_gates(params: SimulationParams, state, mesh, plain, channel):
    """The gates of the z-slab routes, shared by priming and the step with
    the same messages (ROADMAP C7: a state primed on one device and cut
    onto a slab mesh meets them at its first step): a plan of the solve's
    slab rounds in the form h will have (``channel``: the 19-channel h,
    :func:`_channel_form`), and the kernels' grid on the card.  A padded
    layout's solve runs in rounds of any depth (:func:`_solve`), which
    needs no plan.  One batch element a rank and 4 or more planes a slab
    are ``step3d.on_slabs``'s, which routes the rest to the blocks."""
    from ..parallel import step3d

    shape = step3d.global_shape(state.f.shape, mesh)
    if not step3d.fused_step_sharded_ok(mesh, shape, params.kbc_type):
        raise step3d.unported(f"kbc_type={params.kbc_type}")
    padded = params.phys_extent is not None
    if channel and not padded:
        if not step3d.channel_sharded_ok(mesh, (shape[0], 19, *shape[2:]),
                                           params.poisson_iters):
            raise step3d.unported(f"{params.poisson_iters} channel-form sweeps on slabs of "
                                  f"{shape[2] // mesh.nz} planes (no round plan)")
    elif not padded and not step3d.scalar_sharded_ok(mesh, (shape[0], 2, *shape[2:]),
                                                     params.poisson_iters):
        raise step3d.unported(f"{params.poisson_iters} sweeps on slabs of "
                              f"{shape[2] // mesh.nz} planes (no round plan)")
    check_kernel_grid(state.f, plain)


def _block_gates(state, mesh, plain):
    """The gates of the block route, shared by priming and the step with
    the same messages (ROADMAP C7): no premac (the block route steps
    un-carried, as the JAX package's meshed priming leaves it there: a
    state primed on one device and cut onto the mesh refuses here), and the
    kernels' grid on the card.  Returns this rank's
    :class:`~..parallel.blocks.Blocks`, of any number of batch elements a
    rank."""
    from ..parallel import step3d

    blk = step3d.blocks3d(mesh, state.f)
    if state.premac is not None:
        raise ValueError(
            "a premac on the block route (a 3D state on a mesh with a y or x axis, on "
            "z-slabs of under 4 planes, or of two or more batch elements a rank), which steps "
            "un-carried: prime the state on the mesh, "
            "prime_premac(..., mesh=), which carries no premac there (ROADMAP C7)")
    step3d.check_block_grid(blk, state.f, plain)
    return blk


def _channel_form(params: SimulationParams, state, primed, blk=None) -> bool:
    """Whether the step solves on a 19-channel h: ``state.h`` has 19
    channels and, before priming (``primed`` False), the collapse to the
    scalar carry does not apply (``blk``: checked over the whole domain
    from the rank's block)."""
    return state.h.shape[1] != 2 and (primed or not _scalar_physics_ok(
        params, state.magnetic_flags, blk))


def _prime_premac_blocks(params: SimulationParams, state, mesh, plain):
    """:func:`prime_premac` on the block route: h converted to the scalar
    carry across the block's faces where the collapse applies (else the
    19-channel h kept), no premac, phi, force and H_ext kept (JAX
    :979-995, whose meshed priming off the slab gates only converts)."""
    blk = _block_gates(state, mesh, plain)
    validate_mag_shell(params, state.magnetic_flags, blk)
    h, cmask = _scalar_convert(params, state, blk)
    return state.replace(h=h, cmask=cmask)


def _prime_premac_slab(params: SimulationParams, state, mesh, plain):
    """:func:`prime_premac` on a z-slab mesh: B4's slab form, the scalar
    carry converted across the slab's faces where the collapse applies
    (else the 19-channel h kept, JAX ``_scalar_convert(mesh=)`` :845-893),
    and the 6-leaf premac of the capillogue steady state, or with an
    out-of-plane field the 5-leaf one that keeps phi, force and H_ext (JAX
    :979-1022)."""
    from ..parallel import step3d

    blk = step3d.blocks3d(mesh, state.f)
    channel = _channel_form(params, state, False, blk)
    _slab_gates(params, state, mesh, plain, channel)
    validate_mag_shell(params, state.magnetic_flags, blk)
    premac = step3d.fused_prologue_sharded(
        state.f, state.g, state.flags, state.rho, state.vel, mesh, c=params.dx / params.dt,
        rho_gas=params.rho_gas, rho_fluid=params.rho_fluid, density_gas=params.density_gas,
        density_fluid=params.density_fluid, plain=plain,
    )
    h, cmask = state.h, state.cmask
    if h.shape[1] != 2 and not channel:
        h, cmask = step3d.scalar_convert_sharded(state.h, state.magnetic_flags, mesh)
    if params.h_ext_axis == 2:
        return state.replace(h=h, cmask=cmask, premac=tuple(premac))
    rhs = poisson_rhs_scaled(
        phi_from_density(premac[2], params.density_gas, params.density_fluid),
        state.magnetic_flags, _hext_static(params), tau=params.tau,
        dx=params.dx, dt=params.dt,
    )
    return state.replace(h=h, cmask=cmask, premac=tuple(premac) + (rhs,), phi=None,
                         force=None, H_ext=None)


def prime_premac(params: SimulationParams, state: FerrofluidState, *,
                 device=None, plain=False, mesh=None) -> FerrofluidState:
    """Run the prologue once and carry this step's macros and Poisson source
    in ``state.premac`` (a 6-tuple); convert h to the scalar carry where the
    collapse applies (else keep the 19-channel h); drop the write-only phi,
    force and H_ext (``_prime_steady`` of the JAX package).  With an
    out-of-plane field (``h_ext_axis=2``, every padded layout) the premac
    is the 5 macros and phi, force and H_ext stay (JAX :1064-1077).
    A state that is already primed is returned as it is.  In 2D the scalar
    carry is the only priming (JAX :969-977): h converts where the
    collapse applies and nothing else changes.  With ``mesh`` the state is
    this rank's part (module docstring); on a split grid priming runs the
    step's gates first, and on the block route it only converts h.  A
    batch of more than one element (a batch mesh's rank part too) is
    returned as it is, in 2D and 3D, as the JAX package returns it
    (``fused_step_supported`` and the scalar carry need B == 1): it steps
    un-carried on its channel h."""
    blk = None
    if mesh is not None:
        from ..parallel.step3d import dp_dispatch

        device = _on_mesh(state, mesh, device)
        if params.dim == 2:
            blk = mesh_blocks(params, state, mesh, device)
        elif not dp_dispatch(mesh):
            from ..parallel.step3d import on_slabs

            check_device(state.f, device)
            _check_supported(params, state, mesh)
            if not on_slabs(mesh, state.f.shape):
                return _prime_premac_blocks(params, state, mesh, plain)
            if state.premac is not None:
                return state
            return _prime_premac_slab(params, state, mesh, plain)
    check_device(state.f, device)
    _check_supported(params, state, mesh)
    if state.premac is not None:
        # checked when it was primed; the flags check reads the device
        # and would stall every step's enqueue
        return state
    if params.dim == 2:
        h, cmask = _scalar_convert(params, state, blk)
        return state.replace(h=h, cmask=cmask)
    validate_mag_shell(params, state.magnetic_flags)
    if state.f.shape[0] != 1:
        return state
    prologue = lbm_prologue_plain if plain else lbm_prologue
    premac = prologue(
        state.f, state.g, state.flags, state.rho, state.vel,
        c=params.dx / params.dt, rho_gas=params.rho_gas,
        rho_fluid=params.rho_fluid, density_gas=params.density_gas,
        density_fluid=params.density_fluid,
    )
    h, cmask = _scalar_convert(params, state)
    if params.h_ext_axis == 2:
        return state.replace(h=h, cmask=cmask, premac=tuple(premac))
    rhs = poisson_rhs_scaled(
        phi_from_density(premac[2], params.density_gas, params.density_fluid),
        state.magnetic_flags, _hext_static(params), tau=params.tau,
        dx=params.dx, dt=params.dt,
    )
    return state.replace(
        h=h, cmask=cmask, premac=tuple(premac) + (rhs,), phi=None, force=None,
        H_ext=None,
    )


def _solve_slab(params: SimulationParams, state, rhs, mesh, plain):
    """(H2, h') of the magnetic solve on the rank's slab, in the form that
    ``state.h`` has: B1's slab rounds on the scalar carry, else
    :func:`~..ops.magnetic.solve_H_int` with ``mesh`` (B11b's slab rounds,
    the substitution, B10a).  Under the ``mag_flags_shell`` declaration
    ``scalar_sliver`` sends B1's bands as the shell sliver and
    ``poisson_psi_halo`` rebuilds B11b's from psi at tau == 1 (JAX
    :466-471, :509)."""
    from ..parallel import step3d

    shell = params.mag_flags_shell
    if state.h.shape[1] == 2:
        return step3d.scalar_poisson_sharded(state.h, state.cmask, rhs, mesh,
                                             n_iters=params.poisson_iters, dx=float(params.dx),
                                             h_ext=_hext_static(params), plain=plain,
                                             shell_sliver=params.scalar_sliver and shell)
    return solve_H_int(
        params.lattice, state.h, None, state.magnetic_flags, None, tau=float(params.tau),
        n_iters=params.poisson_iters, dx=params.dx, dt=params.dt, rhs_scaled=rhs,
        h2_ext=_hext_static(params), plain=plain, mesh=mesh,
        psi_halo=params.poisson_psi_halo and shell,
    )


def _ferrofluid_step_slab(params: SimulationParams, state, mesh, plain):
    """:func:`ferrofluid_step` on a z-slab mesh, by ``state.premac`` as on
    one device: 6 leaves, the capillogue steady state (the solve, B2, B3;
    JAX :440-472, :588-634); 5 leaves (an in-plane or an out-of-plane
    field) and None, the epilogue route (B4 first when None; the solve, B2,
    B10b, B6, B5 with ``emit_mac`` on 5 leaves; JAX :318-359, :455-471,
    :636-686, :708-735); the solve by the form of ``state.h``
    (:func:`_solve_slab`).  Each kernel runs its slab form
    (``parallel/step3d.py``).  A padded layout (5 leaves or None) takes the
    JAX meshed step's box stages (:422-438, :641-650) on the slab's part of
    the box, where B2, B10b and B6 run: B1's psi passes in rounds and B1's
    H2 launch on the box (:func:`_solve`), B2 on the box and the plain
    capillary stage on the box (:func:`_on_box`), then B5's slab form."""
    from ..parallel import step3d

    _slab_gates(params, state, mesh, plain, channel=state.h.shape[1] != 2)
    premac = state.premac
    if premac is not None and len(premac) not in (5, 6):
        raise ValueError(f"a premac of 5 or 6 leaves, or None; this state carries {len(premac)}")
    if params.h_ext_axis == 2 and premac is not None and len(premac) != 5:
        raise ValueError("an out-of-plane field carries a 5-leaf premac (prime_premac); "
                         f"this state carries {len(premac)} leaves")
    gas = dict(rho_gas=float(params.rho_gas), rho_fluid=float(params.rho_fluid),
               density_gas=float(params.density_gas),
               density_fluid=float(params.density_fluid))
    dx, dt = float(params.dx), float(params.dt)
    grav = tuple(float(v) for v in params.gravity_vec().reshape(-1))
    hcz = dict(tau_f=float(params.tau_f), tau_g=float(params.tau_g), dx=dx, dt=dt)
    if premac is not None and len(premac) == 6:
        rho, vel, density, m0g, m1g, rhs = premac
        H2, h = _solve_slab(params, state, rhs, mesh, plain)
        rho_ca = step3d.contact3d_sharded(rho, state.flags, float(params.contact_angle), mesh,
                                          plain=plain)
        f, g, vel, pressure, density, premac = step3d.capillogue_sharded(
            state.f, state.g, state.flags, rho, density, state.pressure, rho_ca, H2, m0g, m1g,
            vel, state.magnetic_flags, mesh, kappa=float(params.kappa), gravity=grav,
            emit_rhs=(params.h_ext_axis, float(params.mag_strength), float(params.tau)),
            plain=plain, **hcz, **gas,
        )
        return state.replace(f=f, g=g, h=h, rho=rho_ca, vel=vel, density=density,
                             pressure=pressure, step=state.step + 1, premac=premac)
    if premac is None:
        rho, vel, density, m0g, m1g = step3d.fused_prologue_sharded(
            state.f, state.g, state.flags, state.rho, state.vel, mesh, c=dx / dt, plain=plain,
            **gas)
    else:
        rho, vel, density, m0g, m1g = premac
    phi = phi_from_density(density, params.density_gas, params.density_fluid)
    rhs = step3d.poisson_rhs_sharded(phi, state.magnetic_flags, mesh, _hext_static(params),
                                     tau=params.tau, dx=dx, dt=dt)
    if params.phys_extent is not None:
        # the padded solve and box stages on the slab's z-only blocks
        blk = step3d.blocks3d(mesh, state.f)
        H2, h = _solve(params, state, rhs, plain, blk)
        rho_ca = _contact_angle(params, rho, state.flags, plain, blk)
        vel, density_ca, pressure, force, dfai, dprho = _hcz_capillary_box(
            params, rho, rho_ca, vel, state.flags, density, state.pressure, H2, phi, m0g, m1g,
            blk)
    else:
        H2, h = _solve_slab(params, state, rhs, mesh, plain)
        rho_ca = step3d.contact3d_sharded(rho, state.flags, float(params.contact_angle), mesh,
                                          plain=plain)
        density_ca = rho_to_density(rho_ca, **gas)
        # the Laplacian of density(rho_ca) as B6's single-device kernel
        # builds it (B10b maps rho_ca as it loads it)
        lap = step3d.laplacian_field_sharded(rho_ca, mesh, dx=dx,
                                             density_of=tuple(gas.values()), plain=plain)
        vel, pressure, force, dfai, dprho = step3d.capmac_sharded(
            lap, rho, density, state.pressure, rho_ca, H2, phi, state.flags, m0g, m1g, vel,
            mesh, kappa=float(params.kappa), gravity=grav, plain=plain, dx=dx, dt=dt, **gas,
        )
    emit = premac is not None
    out = step3d.fused_epilogue_sharded(
        state.f, state.g, state.flags, rho_ca, vel, density_ca, pressure, force, dfai, dprho,
        mesh, emit_mac=emit, mac_consts=(dx / dt, *gas.values()), plain=plain, **hcz,
    )
    return state.replace(
        f=out[0], g=out[1], h=h, rho=rho_ca, vel=vel, density=density_ca, pressure=pressure,
        force=force, phi=phi, step=state.step + 1, premac=tuple(out[2]) if emit else None,
    )


def ferrofluid_step(params: SimulationParams, state: FerrofluidState, *,
                    device=None, plain=False, mesh=None) -> FerrofluidState:
    """One outer step of the state as it is given; it never primes.

    ``state.premac`` selects the route, as in the JAX step on one device
    (``ferrofluid_step_impl`` :328-344, :393-395, :516, :679-702): 6 leaves,
    the capillogue steady state; 5 leaves, the epilogue steady state (the
    capillogue's box form with an out-of-plane field); None, the un-carried
    step.  ``plain=True`` runs the kernels' plain PyTorch versions (on any
    device) instead of the kernels.  With ``mesh`` the state is this rank's
    part (module docstring)."""
    blk = None
    if mesh is not None:
        from ..parallel.step3d import dp_dispatch

        device = _on_mesh(state, mesh, device)
        if params.dim == 2:
            blk = mesh_blocks(params, state, mesh, device)
        elif not dp_dispatch(mesh):
            from ..parallel.step3d import on_slabs

            check_device(state.f, device)
            _check_supported(params, state, mesh)
            if on_slabs(mesh, state.f.shape):
                return _ferrofluid_step_slab(params, state, mesh, plain)
            return _ferrofluid_step_blocks(params, state, mesh, plain)
    check_device(state.f, device)
    _check_supported(params, state, mesh)
    if params.dim == 2:
        return _ferrofluid_step_2d(params, state, blk)
    check_kernel_grid(state.f, plain)
    gas = dict(rho_gas=float(params.rho_gas), rho_fluid=float(params.rho_fluid),
               density_gas=float(params.density_gas),
               density_fluid=float(params.density_fluid))
    dx, dt = float(params.dx), float(params.dt)
    if state.premac is None:
        prologue = lbm_prologue_plain if plain else lbm_prologue
        rho, vel, density, m0g, m1g = prologue(state.f, state.g, state.flags, state.rho,
                                               state.vel, c=dx / dt, **gas)
    else:
        rho, vel, density, m0g, m1g = state.premac[:5]
    box_form = params.h_ext_axis == 2
    if box_form and state.premac is not None and len(state.premac) != 5:
        raise ValueError("an out-of-plane field carries a 5-leaf premac (prime_premac); "
                         f"this state carries {len(state.premac)} leaves")
    capillogue_route = state.premac is not None and (len(state.premac) == 6 or box_form)
    if state.premac is not None and len(state.premac) == 6:
        rhs = state.premac[5]
    else:
        phi = phi_from_density(density, params.density_gas, params.density_fluid)
        rhs = poisson_rhs_scaled(phi, state.magnetic_flags, _hext_static(params),
                                 tau=params.tau, dx=dx, dt=dt)
    H2, h = _solve(params, state, rhs, plain)
    rho_ca = _contact_angle(params, rho, state.flags, plain)
    grav = tuple(float(v) for v in params.gravity_vec().reshape(-1))
    hcz = dict(tau_f=float(params.tau_f), tau_g=float(params.tau_g), dx=dx, dt=dt)
    if capillogue_route:
        # an out-of-plane field takes the box form: force written, no source
        # emitted, the in-plane ring fixes at the box faces of a padded
        # layout (JAX :549-580)
        capillogue = lbm_capillogue_plain if plain else lbm_capillogue
        out = capillogue(
            state.f, state.g, state.flags, rho, density, state.pressure, rho_ca, H2,
            m0g, m1g, vel, None if box_form else state.magnetic_flags,
            kappa=float(params.kappa), gravity=grav,
            emit_rhs=None if box_form else (params.h_ext_axis, float(params.mag_strength),
                                            float(params.tau)),
            emit_force=box_form,
            bounds=tuple(params.phys_extent[1:]) if params.phys_extent else None,
            **gas, **hcz,
        )
        f, g, vel, pressure, density, premac = out[:6]
        return state.replace(
            f=f, g=g, h=h, rho=rho_ca, vel=vel, density=density, pressure=pressure,
            step=state.step + 1, premac=premac,
            **(dict(force=out[6], phi=phi) if box_form else {}),
        )
    # the 5-leaf and the un-carried routes: B2 + B6 with H2 and phi (on a
    # padded layout the plain stage on the box, JAX :641-650), then the
    # epilogue (models/multiphase.py's composition)
    if params.phys_extent is not None:
        vel, density, pressure, force, dfai, dprho = _hcz_capillary_box(
            params, rho, rho_ca, vel, state.flags, density, state.pressure, H2, phi, m0g, m1g)
    else:
        capillary = hcz_capillary_gradmac_plain if plain else hcz_capillary_gradmac
        vel, pressure, force, dfai, dprho = capillary(
            rho, density, state.pressure, rho_ca, H2, phi, state.flags, m0g, m1g, vel,
            kappa=float(params.kappa), gravity=grav, dx=dx, dt=dt, **gas,
        )
        density = rho_to_density(rho_ca, **gas)
    epilogue = lbm_epilogue_plain if plain else lbm_epilogue
    emit = state.premac is not None
    out = epilogue(state.f, state.g, state.flags, rho_ca, vel, density, pressure, force, dfai,
                   dprho, emit_mac=emit, mac_consts=(dx / dt, *gas.values()), **hcz)
    return state.replace(
        f=out[0], g=out[1], h=h, rho=rho_ca, vel=vel, density=density, pressure=pressure,
        force=force, phi=phi, step=state.step + 1, premac=tuple(out[2]) if emit else None,
    )


def _ferrofluid_step_blocks(params: SimulationParams, state, mesh, plain):
    """:func:`ferrofluid_step` on the block route: the un-carried step (B4,
    the Poisson source, the solve by the form of ``state.h``, B2, B6, B5;
    JAX :318-359, :394-507, :636-735 under GSPMD), every kernel the
    single-device one on the rank's block extended under its edge rule
    (``parallel/blocks.py:HALOS``); the fields read deeper later are
    extended first, one exchange a dtype.  A padded layout takes the box
    stages of one device's un-carried step in place of B2 and B6 (B2 and
    the plain capillary stage on the rank's part of the box,
    :func:`_on_box`)."""
    from ..parallel import step3d

    blk = _block_gates(state, mesh, plain)
    gas = dict(rho_gas=float(params.rho_gas), rho_fluid=float(params.rho_fluid),
               density_gas=float(params.density_gas),
               density_fluid=float(params.density_fluid))
    dx, dt = float(params.dx), float(params.dt)
    blk.extend([state.f, state.g], 1)
    blk.extend([state.flags, state.magnetic_flags],
               step3d.solve_depth(blk, params.poisson_iters))
    prologue = lbm_prologue_plain if plain else lbm_prologue
    rho, vel, density, m0g, m1g = blk.op(prologue)(state.f, state.g, state.flags, state.rho,
                                                   state.vel, c=dx / dt, **gas)
    phi = phi_from_density(density, params.density_gas, params.density_fluid)
    # the source's and B2's and B6's stencil fields of this step's macros
    blk.extend([phi, rho, density, state.pressure], 3)
    rhs = blk.op(poisson_rhs_scaled)(phi, state.magnetic_flags, _hext_static(params),
                                     tau=params.tau, dx=dx, dt=dt)
    H2, h = _solve(params, state, rhs, plain, blk)
    if params.phys_extent is not None:
        rho_ca = _contact_angle(params, rho, state.flags, plain, blk)
        vel, density, pressure, force, dfai, dprho = _hcz_capillary_box(
            params, rho, rho_ca, vel, state.flags, density, state.pressure, H2, phi, m0g, m1g,
            blk)
    else:
        surgery = contact_angle_3d_plain if plain else contact_angle_3d
        rho_ca = blk.op(surgery)(rho, state.flags, float(params.contact_angle))
        capillary = hcz_capillary_gradmac_plain if plain else hcz_capillary_gradmac
        grav = tuple(float(v) for v in params.gravity_vec().reshape(-1))
        vel, pressure, force, dfai, dprho = blk.op(capillary)(
            rho, density, state.pressure, rho_ca, H2, phi, state.flags, m0g, m1g, vel,
            kappa=float(params.kappa), gravity=grav, dx=dx, dt=dt, **gas,
        )
        density = rho_to_density(rho_ca, **gas)
    epilogue = lbm_epilogue_plain if plain else lbm_epilogue
    f, g = blk.op(epilogue)(state.f, state.g, state.flags, rho_ca, vel, density, pressure, force,
                            dfai, dprho, tau_f=float(params.tau_f), tau_g=float(params.tau_g),
                            dx=dx, dt=dt)
    return state.replace(f=f, g=g, h=h, rho=rho_ca, vel=vel, density=density, pressure=pressure,
                         force=force, phi=phi, step=state.step + 1, premac=None)


def _ferrofluid_step_2d(params: SimulationParams, state, blk=None):
    """One 2D step: the JAX step's unfused branch (:358-371), the solve by
    the form of ``state.h`` (:394-507) and the shared HCZ stages with H2
    and phi (:636-766); with ``blk`` on the rank's block of a y/x mesh
    (``parallel/step2d.py``: the same ops, the solve's sweeps in rounds)."""
    f, rho, vel, density, g, m0g, m1g = stream_2d(params, state, blk)
    phi = phi_from_density(density, params.density_gas, params.density_fluid)
    hext = _hext_static(params)
    dx, dt = float(params.dx), float(params.dt)
    if state.h.shape[1] == 2:
        rhs = on_block(blk, poisson_rhs_scaled)(phi, state.magnetic_flags, hext,
                                                tau=float(params.tau), dx=dx, dt=dt)
        H2, h = solve_H_int_scalar(state.h, state.cmask, rhs, n_iters=params.poisson_iters,
                                   dx=dx, h2_ext=hext, magnetic_flags=state.magnetic_flags,
                                   blocks=blk)
    else:
        H2, h = solve_H_int(params.lattice, state.h, phi, state.magnetic_flags,
                            state.H_ext_mac, tau=float(params.tau),
                            n_iters=params.poisson_iters, dx=dx, dt=dt, h2_ext=hext,
                            blocks=blk)
    f, g, rho, vel, density, pressure, force = capillary_collide_2d(
        params, state, f, g, rho, vel, density, m0g, m1g, H2, phi, blk=blk)
    return state.replace(f=f, g=g, h=h, rho=rho, vel=vel, density=density,
                         pressure=pressure, force=force, phi=phi, step=state.step + 1)


def _solve(params: SimulationParams, state, rhs, plain, blk=None):
    """(H2, h') of the magnetic solve in the form that ``state.h`` has; with
    ``blk`` on the rank's block (the block route, and a padded layout's
    slabs).  A padded layout runs the scalar sweeps on the padded arrays
    and composes H2 on the box (JAX :422-439); its channel form raises, as
    the JAX step's (:485-493), since that solve composes its gradient at
    the array faces."""
    if state.h.shape[1] == 2 and params.phys_extent is not None:
        psi, h = solve_psi_scalar(state.h, state.cmask, rhs, n_iters=params.poisson_iters,
                                  plain=plain, blocks=blk)
        return _h2_box(params, psi, state.cmask, plain, blk), h
    if params.phys_extent is not None:
        raise NotImplementedError(
            "phys_extent layouts require the tau == 1 scalar Poisson carry: prime_premac "
            "converts h where the collapse applies (tau 1, scalar_carry, the pad all "
            "OBSTACLE and the box's interior free of magnetic obstacles)")
    if state.h.shape[1] == 2:
        return solve_H_int_scalar(
            state.h, state.cmask, rhs, n_iters=params.poisson_iters, dx=params.dx,
            h2_ext=_hext_static(params), plain=plain, blocks=blk,
        )
    return solve_H_int(
        params.lattice, state.h, None, state.magnetic_flags, None, tau=float(params.tau),
        n_iters=params.poisson_iters, dx=params.dx, dt=params.dt, rhs_scaled=rhs,
        h2_ext=_hext_static(params), plain=plain, blocks=blk,
    )
