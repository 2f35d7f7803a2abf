"""B3: the capillogue, capillary stage + HCZ collide + next-step emission.

Replaces the TPU kernel ``lbm_ferrofluid_tpu/ops/pallas/capillogue.py:
lbm_capillogue`` (:809).  The TPU kernel collides f and g in place, which is
safe there only because its z-ring reads lead its writes; its emission
streams collided neighbours held in that ring.  GPU blocks run in any order
with no grid-wide barrier, so the CUDA source ``csrc/capillogue.cu`` runs a
chain of ``N_LAUNCHES`` = 4 launches and collides out of place into a new
f/g pair:

  (a) fai, prho, chi and the Laplacian of density(rho_ca), into scratch;
  (b) gradients, force, velocity/pressure recovery, re-stream and collide
      (dfai and dprho stay in registers): blocks walk z over 32 x 8 tiles
      with the stencil fields in a 3-plane shared-memory ring, and the
      collide keeps per-cell scalars only, two blocks an SM;
  (c) the prologue kernel on f'/g' with rho_old = rho_ca and vel_old = the
      recovered velocity (the next step's rho, vel, density, m0g, m1g);
  (d) the next step's pre-scaled Poisson source from the emitted density.

The steady state with an in-plane field emits no force (the reference
overwrites it unread each step, LBM_collision_HCZ_3d.py:225).  The box form
(``emit_rhs=None, emit_force=True``, optionally ``bounds``), which the JAX
step takes for an out-of-plane field and for the padded transposed layout
(``models/ferrofluid.py:549-571`` there), writes force, skips (d), and with
``bounds = (by, bx)`` puts the in-plane ring fixes at the faces of the
physical box ``[..., :by, :bx]`` (``csrc/capillogue.cu``).  The plain
version is the composition ``hcz_capillary`` -> ``hcz_collide`` ->
``stream_bounce_macro/moments`` -> ``poisson_rhs_scaled``.

f and g may be stored in bfloat16 (the JAX package's turbo mode): launches
(b) and (c) then run their kernels' bfloat16 instances, (b) rounding f'/g'
once on the store and (c) reading those stored values, as the TPU
kernel's emission re-streams f'/g' through the storage dtype.

Bound on an H100: bytes, 382 B per cell plus 20 B per fluid and 12 B per
other cell (see :func:`cost`): 2.01 ms at 256^3 over 3.35 TB/s; 230 B per
cell plus the same, 1.23 ms, in bfloat16 storage.

The slab form (``ghosts``, ``cap_ghosts``, ``clamp`` and ``emit_ghosts``,
the TPU kernel's ghost mode, for a z-slab of a domain decomposed along z
over ranks: ``parallel/step3d.py``) takes the neighbours' edge planes:
``ghosts = (f_lo, f_hi, g_lo, g_hi)`` as B4's slab form takes them
(``fused_step.ghost_planes``), ``cap_ghosts = (lo, hi)`` two [1, 6, Y, X]
float32 bundles of (rho_pre, density_pre, pressure_old, rho_ca, rho_ca,
flags) with the plane below the slab (lo: rho_ca planes -2 and -1) and above
it (hi: planes Zl and Zl + 1), see :func:`cap_bundle`, and ``clamp = (zlo,
zhi)``, the capillary stage's z clamp (1 and Zl-2 at the domain's true
edges, -1 and Zl where the slab has a neighbour).  (a) runs over the slab
and one plane a side, so that (b) sees the neighbours' Laplacian of
density(rho_ca); (b) pulls f and g across the slab's faces from their
ghosts; between (b) and (c) ``emit_ghosts(f', g')`` returns the
neighbours' collided edge planes in ``ghosts``' format (the caller's
exchange), and (c) is B4's slab form on them, so every plane's macros are
emitted in the kernels.  Four launches (``launches_slab``).  The plain
version: the stream of f and g extended by their ghosts, the capillary
stage on the slab extended by two planes on each side that has a
neighbour, then as on the whole domain.
"""

from __future__ import annotations

import ctypes

import torch

from ...lattice import D3Q19
from ...utils.types import CellType
from ..collide import MU0, hcz_capillary, hcz_collide
from ..magnetic import poisson_rhs_scaled
from ..moments import phi_from_density
from ..stream import bounce_back, stream
from ._lib import (STORAGE, call, check_cuda, check_no_grad, check_slab_clamp, check_unbatched,
                   count_launch, elem_bytes, ptr, stream_of)
from .fused_step import cost as prologue_cost
from .fused_step import extend_ghosts, lbm_prologue_plain, repeat_ends, stream_macro_launch

__all__ = ["lbm_capillogue", "lbm_capillogue_plain", "cost", "cost_slab", "N_LAUNCHES",
           "launches_per_call", "cap_bundle", "cap_extend", "CAP_PLANES"]

TPU_KERNEL = "lbm_ferrofluid_tpu/ops/pallas/capillogue.py:809"
CUDA_SOURCE = "lbm_ferrofluid_tpu_torch/csrc/capillogue.cu"
N_LAUNCHES = 4


def cost(f, g, flags, rho_pre, density_pre, pressure_old, rho_ca, H2, g_sum, g_mom,
         vel_old, magnetic_flags, *, emit_rhs=True, emit_force=False,
         **_) -> tuple[int, int]:
    """(bytes, flops) that a call on these inputs must move and do.

    Bytes: f, g (in their storage type), both flag fields, rho_pre,
    density_pre, pressure_old and
    rho_ca read at every cell (the stencils reach every cell); H2, g_sum
    and g_mom only at fluid cells (the force and the recovery are used
    nowhere else) and vel_old only at the others; f', g' and 15 float
    channels written.  Flops: (a) ~110 per cell (EOS, chi, 19-point
    Laplacian of the density map), (b) ~1000 per fluid cell (4 x 3
    gradient components, force and recovery, 19 x 2 equilibrium/forcing
    updates; other cells keep their bounced values), (c) the prologue's
    count on the emitted fields, (d) ~52 per magnetic fluid cell (chi at
    three cells and the staggered difference).  ``emit_rhs`` and
    ``emit_force`` as the call's: the box form (``emit_rhs=None``) reads
    no magnetic flags and does no (d); force adds 3 float channels."""
    n = flags.numel()
    fluid = int(CellType.FLUID)
    n_fluid = int((flags == fluid).sum())
    fg = 19 * (elem_bytes(f) + elem_bytes(g))
    rhs = emit_rhs is not None
    written = 14 + (3 if emit_force else 0) + (1 if rhs else 0)
    nbytes = (n * (2 * fg + 1 + rhs + 4 * 4 + written * 4) + 20 * n_fluid
              + 12 * (n - n_fluid))
    flops = 110 * n + 1000 * n_fluid + prologue_cost(f, g, flags, rho_ca, vel_old)[1]
    if rhs:
        flops += 52 * int((magnetic_flags == fluid).sum())
    return nbytes, flops


#: the planes of a ``cap_ghosts`` bundle, in order
CAP_PLANES = ("rho_pre", "density_pre", "pressure_old", "rho_ca", "rho_ca", "flags")


def cap_bundle(rho_pre, density_pre, pressure_old, rho_ca, flags, side):
    """The [1, 6, Y, X] float32 bundle of a slab's edge planes that its
    neighbour on ``side`` ("lo": the rank below, which takes the slab's top
    planes; "hi": the rank above, its bottom planes) needs: rho_pre,
    density_pre, pressure_old and flags (as float) of the edge plane and
    the two rho_ca planes nearest to it, in z order."""
    if side == "lo":
        one, two = slice(-1, None), slice(-2, None)
    else:
        one, two = slice(0, 1), slice(0, 2)
    return torch.cat([rho_pre[:, :, one], density_pre[:, :, one], pressure_old[:, :, one],
                      rho_ca[:, :, two], flags[:, :, one].to(rho_pre.dtype)], dim=2)[:, 0]


def cost_slab(f, g, flags, rho_pre, density_pre, pressure_old, rho_ca, H2, g_sum, g_mom,
              vel_old, magnetic_flags, *, emit_rhs=True, emit_force=False, ghosts=None,
              cap_ghosts=None, **_) -> tuple[int, int]:
    """:func:`cost` of the slab form: the ghost planes of f and g twice (for
    (b) and, collided, for (c)) and the two capillary bundles read once
    more."""
    nbytes, flops = cost(f, g, flags, rho_pre, density_pre, pressure_old, rho_ca, H2, g_sum,
                         g_mom, vel_old, magnetic_flags, emit_rhs=emit_rhs,
                         emit_force=emit_force)
    gh = 2 * sum(t.numel() * t.element_size() for t in ghosts)
    return nbytes + gh + sum(t.numel() * 4 for t in cap_ghosts), flops


def cap_extend(x, lo, hi, clamp):
    """``x`` extended by two planes on each side with a neighbour (``clamp``'s
    -1 or Zl), ``lo``/``hi`` (one or two planes, [1, C, n, Y, X]) nearest the
    slab and the outer plane repeated to two (the slab's edge plane where
    None); nothing on a side that is a true edge."""
    def two(planes):
        return planes if planes.shape[2] == 2 else torch.cat([planes, planes], dim=2)

    parts = [x]
    if clamp[0] < 0:
        parts.insert(0, two(x[:, :, :1] if lo is None else lo))
    if clamp[1] >= x.shape[2]:
        parts.append(two(x[:, :, -1:] if hi is None else hi))
    return torch.cat(parts, dim=2)


def _capillary_slab(rho_pre, vel_old, flags, density_pre, pressure_old, rho_ca, H2, g_sum,
                    g_mom, cap_ghosts, clamp, **kw):
    """The plain capillary stage of a slab: ``hcz_capillary`` on the slab
    extended by two planes on each side with a neighbour (the neighbour's
    planes next to the slab from ``cap_ghosts``, two of rho_ca for the
    Laplacian of the nearer), whose taps then reach the slab's planes as
    the whole domain's would; fields read only at the cell itself extend by
    repeats, as do the outer planes, which no kept plane reads."""
    lo, hi = cap_ghosts

    def ext(x, j=None, n=1):
        if j is None:
            return cap_extend(x, None, None, clamp)
        return cap_extend(x, lo[:, None, j:j + n], hi[:, None, j:j + n], clamp)

    density = ext(density_pre, 1)
    out = hcz_capillary(
        ext(rho_pre, 0), ext(vel_old), ext(flags.to(rho_pre.dtype), 5).to(flags.dtype), density,
        ext(pressure_old, 2), ext(rho_ca, 3, 2), ext(H2),
        phi_from_density(density, kw["density_gas"], kw["density_fluid"]), ext(g_sum),
        ext(g_mom), **kw,
    )
    start = 2 if clamp[0] < 0 else 0
    Z = flags.shape[2]
    return tuple(x[:, :, start:start + Z] for x in out)


def lbm_capillogue_plain(f, g, flags, rho_pre, density_pre, pressure_old, rho_ca,
                         H2, g_sum, g_mom, vel_old, magnetic_flags, ghosts=None,
                         cap_ghosts=None, clamp=None, emit_ghosts=None, *, kappa, gravity,
                         rho_gas, rho_fluid, density_gas, density_fluid, tau_f,
                         tau_g, dx=1.0, dt=1.0, emit_rhs, emit_force=False, bounds=None):
    """Plain PyTorch version of :func:`lbm_capillogue`."""
    lat = D3Q19
    slab = ghosts is not None
    if slab:
        f_lo, f_hi, g_lo, g_hi = ghosts
        f_post = bounce_back(lat, stream(lat, extend_ghosts(f, f_lo, f_hi)),
                             repeat_ends(flags))[:, :, 1:-1]
        g_post = bounce_back(lat, stream(lat, extend_ghosts(g, g_lo, g_hi)),
                             repeat_ends(flags))[:, :, 1:-1]
    else:
        f_post = bounce_back(lat, stream(lat, f), flags)
        g_post = bounce_back(lat, stream(lat, g), flags)
    grav = torch.tensor(gravity, dtype=vel_old.dtype, device=vel_old.device)
    cap_kw = dict(kappa=kappa, gravity=grav.reshape(1, 3, 1, 1, 1), rho_gas=rho_gas,
                  rho_fluid=rho_fluid, density_gas=density_gas,
                  density_fluid=density_fluid, dx=dx, dt=dt, bounds=bounds)
    if slab:
        rho, vel, den, pres, force, dfai, dprho = _capillary_slab(
            rho_pre, vel_old, flags, density_pre, pressure_old, rho_ca, H2, g_sum, g_mom,
            cap_ghosts, clamp, **cap_kw)
    else:
        rho, vel, den, pres, force, dfai, dprho = hcz_capillary(
            rho_pre, vel_old, flags, density_pre, pressure_old, rho_ca, H2,
            phi_from_density(density_pre, density_gas, density_fluid), g_sum, g_mom, **cap_kw)
    f_n, g_n = hcz_collide(
        lat, f_post, g_post, rho, vel, den, pres, flags, force, dfai, dprho,
        tau_f=tau_f, tau_g=tau_g, dx=dx, dt=dt,
    )
    mac = lbm_prologue_plain(
        f_n, g_n, flags, rho, vel, emit_ghosts(f_n, g_n) if slab else None, c=dx / dt,
        rho_gas=rho_gas, rho_fluid=rho_fluid, density_gas=density_gas,
        density_fluid=density_fluid,
    )
    if emit_rhs is not None:
        axis, hm, tau_mag = emit_rhs
        h_ext = tuple(float(hm) if d == axis else 0.0 for d in range(3))
        mac = mac + (poisson_rhs_scaled(
            phi_from_density(mac[2], density_gas, density_fluid), magnetic_flags, h_ext,
            tau=tau_mag, dx=dx, dt=dt,
        ),)
    return (f_n, g_n, vel, pres, den, mac) + ((force,) if emit_force else ())


def lbm_capillogue(f, g, flags, rho_pre, density_pre, pressure_old, rho_ca, H2,
                   g_sum, g_mom, vel_old, magnetic_flags, ghosts=None, cap_ghosts=None,
                   clamp=None, emit_ghosts=None, *, kappa, gravity,
                   rho_gas, rho_fluid, density_gas, density_fluid, tau_f, tau_g,
                   dx=1.0, dt=1.0, emit_rhs, emit_force=False, bounds=None):
    """One steady-state pass: capillary stage, HCZ collide, next-step emission.

    ``rho_pre``/``density_pre``/``g_sum``/``g_mom``/``vel_old`` come from
    the carried premac, ``pressure_old`` from the state, ``rho_ca`` from the
    contact-angle kernel, ``H2`` from the Poisson solve; ``gravity`` is a
    3-tuple and ``emit_rhs = (axis, magnitude, tau)`` the static external
    field along x (0) or y (1), or None (no source emitted, and
    ``magnetic_flags`` may be None).  ``emit_force`` adds the 3-channel
    force output; ``bounds = (by, bx)`` the in-plane box of a padded layout.
    ``ghosts``, ``cap_ghosts``, ``clamp`` and ``emit_ghosts`` together give
    the slab form (module docstring).
    Returns ``(f', g', vel, pressure, density(rho_ca), premac)`` with premac
    the (rho, vel, density, m0g, m1g) of the next step, plus rhs_scaled
    with ``emit_rhs``, and force appended last with ``emit_force``.
    CPU tensors take the plain version; CUDA tensors launch the kernels on
    their card; anything else raises.  Inputs are not modified.
    """
    slab = ghosts is not None
    if {slab} != {cap_ghosts is not None, clamp is not None, emit_ghosts is not None}:
        raise ValueError("lbm_capillogue: give ghosts, cap_ghosts, clamp and emit_ghosts "
                         "together, or none of them")
    if slab and bounds is not None:
        raise ValueError("lbm_capillogue: the slab form has no box form (bounds)")
    kw = dict(kappa=kappa, gravity=gravity, rho_gas=rho_gas, rho_fluid=rho_fluid,
              density_gas=density_gas, density_fluid=density_fluid, tau_f=tau_f,
              tau_g=tau_g, dx=dx, dt=dt, emit_rhs=emit_rhs, emit_force=emit_force,
              bounds=bounds)
    if f.device.type == "cpu":
        return lbm_capillogue_plain(
            f, g, flags, rho_pre, density_pre, pressure_old, rho_ca, H2, g_sum,
            g_mom, vel_old, magnetic_flags, ghosts, cap_ghosts, clamp, emit_ghosts, **kw,
        )
    check_no_grad("lbm_capillogue", f, g, rho_pre, density_pre, pressure_old, rho_ca, H2,
                  g_sum, g_mom, vel_old)
    B, Q, Z, Y, X = f.shape
    check_unbatched("lbm_capillogue", B)
    scalar = (1, 1, Z, Y, X)
    for name, t in (("rho_pre", rho_pre), ("density_pre", density_pre),
                    ("pressure_old", pressure_old), ("rho_ca", rho_ca), ("H2", H2),
                    ("g_sum", g_sum)):
        check_cuda(name, t, torch.float32, scalar)
    check_cuda("g_mom", g_mom, torch.float32, (1, 3, Z, Y, X))
    if emit_rhs is not None:
        check_cuda("magnetic_flags", magnetic_flags, torch.uint8, scalar)
    check_cuda("f", f, STORAGE, (1, 19, Z, Y, X))
    check_cuda("g", g, (f.dtype,), (1, 19, Z, Y, X))
    check_cuda("flags", flags, torch.uint8, scalar)
    check_cuda("vel_old", vel_old, torch.float32, (1, 3, Z, Y, X))
    if emit_rhs is not None and emit_rhs[0] not in (0, 1):
        raise ValueError("lbm_capillogue emits the source for an in-plane field axis only")
    by, bx = bounds if bounds is not None else (Y, X)
    if min(Z, Y, X) < 3 or not (3 <= by <= Y and 3 <= bx <= X):
        raise ValueError("lbm_capillogue needs Z, Y, X >= 3 and a box of 3 to Y x X cells")
    if slab:
        for name, t in zip(("f_lo", "f_hi", "g_lo", "g_hi"), ghosts, strict=True):
            check_cuda(name, t, (f.dtype,), (1, 5, 1, Y, X))
        for name, t in zip(("cap_lo", "cap_hi"), cap_ghosts, strict=True):
            check_cuda(name, t, torch.float32, (1, len(CAP_PLANES), Y, X))
        check_slab_clamp("lbm_capillogue", clamp, Z, 4)
    box = (ctypes.c_int(by), ctypes.c_int(bx))
    form = "slab" if slab else ("box" if emit_rhs is None else None)
    dims = (ctypes.c_int(Z), ctypes.c_int(Y), ctypes.c_int(X))
    gas = tuple(ctypes.c_double(float(v))
                for v in (rho_gas, rho_fluid, density_gas, density_fluid))
    st = stream_of(f)
    bf16 = f.dtype == torch.bfloat16

    scratch = torch.empty((4, 1, Z + 2 * slab, Y, X), dtype=torch.float32, device=f.device)
    fai, prho, chi, lap = scratch
    if slab:
        lo, hi = cap_ghosts
        call("lbm_cap_derived_slab", ptr(rho_pre), ptr(density_pre), ptr(pressure_old),
             ptr(rho_ca), ptr(fai), ptr(prho), ptr(chi), ptr(lap), *dims, *box,
             ctypes.c_double(dx), ctypes.c_double(dt), *gas,
             *(ptr(b[:, j]) for j in range(3) for b in (lo, hi)),
             ptr(lo[:, 3]), ptr(hi[:, 3]), *(ctypes.c_int(v) for v in clamp), st)
    else:
        call("lbm_cap_derived", ptr(rho_pre), ptr(density_pre), ptr(pressure_old), ptr(rho_ca),
             ptr(fai), ptr(prho), ptr(chi), ptr(lap), *dims, *box, ctypes.c_double(dx),
             ctypes.c_double(dt), *gas, st)
    count_launch(lbm_capillogue, bf16, form)

    f_out, g_out = torch.empty_like(f), torch.empty_like(g)
    vel, pres, den = torch.empty_like(vel_old), torch.empty_like(rho_ca), torch.empty_like(rho_ca)
    force = torch.empty_like(vel_old) if emit_force else None
    args = (ptr(f), ptr(g), ptr(flags), ptr(rho_ca),
            ptr(H2), ptr(g_sum), ptr(g_mom), ptr(vel_old), ptr(pressure_old), ptr(fai),
            ptr(prho), ptr(chi), ptr(lap), ptr(f_out), ptr(g_out), ptr(vel), ptr(pres),
            ptr(den), ptr(force), *dims, *box, ctypes.c_double(kappa),
            *(ctypes.c_double(float(v)) for v in gravity), ctypes.c_double(0.5 * MU0),
            ctypes.c_double(tau_f), ctypes.c_double(tau_g), ctypes.c_double(dx),
            ctypes.c_double(dt), *gas, ctypes.c_int(bf16))
    if slab:
        fl_lo, fl_hi = (b[:, CAP_PLANES.index("flags")].to(torch.uint8) for b in cap_ghosts)
        call("lbm_cap_collide_slab", *args, *(ptr(t) for t in ghosts), ptr(fl_lo), ptr(fl_hi),
             *(ctypes.c_int(v) for v in clamp), st)
    else:
        call("lbm_cap_collide", *args, st)
    count_launch(lbm_capillogue, bf16, form)

    mac = stream_macro_launch(
        f_out, g_out, flags, rho_ca, vel,
        (dx / dt, rho_gas, rho_fluid, density_gas, density_fluid),
        emit_ghosts(f_out, g_out) if slab else None,
    )
    count_launch(lbm_capillogue, bf16, form)
    if emit_rhs is not None:
        axis, hm, tau_mag = emit_rhs
        rhs = torch.empty_like(rho_ca)
        call("lbm_cap_rhs", ptr(mac[2]), ptr(magnetic_flags), ptr(rhs), *dims,
             ctypes.c_int(axis), ctypes.c_double(hm), ctypes.c_double(tau_mag),
             ctypes.c_double(dx), ctypes.c_double(dt), gas[2], gas[3], st)
        count_launch(lbm_capillogue, bf16, "slab" if slab else None)
        mac = mac + (rhs,)
    return (f_out, g_out, vel, pres, den, mac) + ((force,) if emit_force else ())


def launches_per_call(emit_rhs) -> int:
    """Launches of one :func:`lbm_capillogue` call: ``N_LAUNCHES``, or one
    fewer in the box form (no source emitted)."""
    return N_LAUNCHES if emit_rhs is not None else N_LAUNCHES - 1


lbm_capillogue.launches = 0
lbm_capillogue.launches_bf16 = 0
lbm_capillogue.launches_box = 0
lbm_capillogue.launches_slab = 0
