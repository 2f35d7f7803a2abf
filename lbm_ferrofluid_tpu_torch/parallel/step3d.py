"""The decomposition of the 3D steps over ranks: z-slabs and blocks.

Port of ``lbm_ferrofluid_tpu/parallel/step3d.py`` for the ferrofluid step
(``models/ferrofluid.py``) in either form of its magnetic solve and the
HCZ step (``models/multiphase.py``).  The JAX package runs each Pallas
kernel inside ``shard_map`` over a ('batch', 'z') mesh and feeds its ghost
mode from ``ppermute`` ring exchanges; here each rank is a process that
holds its slab (``parallel/sharding.py``), runs the slab form of each
kernel (``ops/kernels``: B4, B1, B11b, B10a, B2, B3, B10b, B6, B5, B8a,
B8b with ``ghosts=``; B9 is local) and exchanges the ghost planes with
:func:`~.halo.ring_halo`, each exchange with its own tag:

* priming, and each un-carried step: :func:`fused_prologue_sharded` (B4's
  slab form, the f and g planes the pulls cross the slab's faces for);
* each step: :func:`scalar_poisson_sharded` (rounds of k sweeps of B1's
  slab form on the slab and G = k + 1 ghost planes a side, read in place:
  the (cmask, rhs) bands exchanged once, the boundary bands of (s,
  s_prev) between rounds, under ``scalar_sliver`` as the shell's sliver,
  H2 from the last) and :func:`contact3d_sharded` (B2's, one rho plane a
  side);
* the capillogue steady state (6-leaf premac): :func:`capillogue_sharded`
  (B3's: the f and g planes, one bundle of the capillary fields' planes a
  side, and one exchange of the collided edge planes between its collide
  and its emission);
* the epilogue route (5-leaf premac, and the un-carried step):
  :func:`poisson_rhs_sharded` (the Poisson source; an out-of-plane field's
  reads phi a plane across the faces), :func:`laplacian_field_sharded`
  (B10b's, of density(rho_ca), one rho_ca plane a side),
  :func:`capmac_sharded` (B6's, one bundle of the stencil fields' planes a
  side, the Laplacian an input) and :func:`fused_epilogue_sharded` (B5's:
  the f and g planes, and with ``emit_mac`` the collided edge planes
  before B4's slab form emits the next step's macros);
* a 19-channel h (the channel-form solve, ``ops/magnetic.py:solve_H_int``
  with ``mesh``): :func:`poisson_sweeps_sharded` (rounds of one launch of
  k <= 4 sweeps of B11b's slab form, the slab read in place with G = k
  band planes a side, the bands of each round's output exchanged before
  the next, the flags' and rhs' bands exchanged once and read in place
  beside the caller's flags and rhs: :func:`channel_slab_plan`; under
  ``poisson_psi_halo`` at tau 1 each band after the first round rebuilt
  from the neighbour's psi by ``lbm_psi_ghost_band``), whose last round's
  trailing stage (B7's ``emit="h2"``) emits H2 with the z clamp at the
  domain's true edges only, from G = k + 1 band planes; where :func:`channel_slab_plan` with ``h2=True`` refuses, psi and
  then :func:`substitute_obstacles_sharded` (local: the z pad at true edges
  only) and :func:`grad_fields_sharded` (B10a's, one psi plane a side);
* the HCZ step: :func:`stream_bounce_macro_sharded` and
  :func:`stream_bounce_moments_sharded` (B8b's and B8a's, one 5-channel
  plane a side), then B2, B10b, B6 as above and B9, which is local.

At ``nz == 1`` the mesh is data parallel over ``batch`` (or one rank): each
rank holds the whole z of its batch element and runs the single-device
kernels (:func:`dp_dispatch`), unless the mesh is made with ``slab=True``,
which keeps the slab forms with the rank's own wrap as its ghosts (the JAX
package's ``LBM_SLAB_FORCE``).

The slab forms take a ferrofluid or HCZ state on z and batch axes only,
one batch element a rank, in slabs of 4 or more planes (:func:`on_slabs`).
Every other 3D state on a split grid takes the block route
(:func:`blocks3d`, the JAX package's GSPMD route where its slab gates
fail, ``lbm_ferrofluid_tpu/parallel/step3d.py:76-98``), two or more batch
elements a rank among them (the JAX package's slab kernels need ``B // nb
== 1``, :92 there): its [B_local, C, bz, by, bx] block steps through the
single-device kernels themselves, each on the block extended by ghost cells
under its edge rule (``parallel/blocks.py:HALOS``) and each launch taking
the rank's whole batch, bit for bit to one device's batched steps on the
same route.  The ferrofluid step there is the un-carried route (B4, the
solve, B2, B6, B5), whose every launch has one edge rule; its solve runs
in rounds (:func:`scalar_poisson_blocks`: B1's passes and its H2 launch;
:func:`channel_poisson_blocks`: B11b's passes, then the substitution and
B10a, the psi route).  The HCZ step runs B8b, B8a, B2, B6 and B9, single
phase B8a, and Shan-Chen its plain ops (it has no kernel).

The gates take GLOBAL [B, C, Z, Y, X] shapes, as the JAX package's; their
structural conditions are the port's (the TPU's alignment and VMEM gates
are not: ROADMAP ground rules).  Every function here takes and returns the
rank's own slab; ``plain=True`` runs the slab forms' plain versions.
"""

from __future__ import annotations

import torch

from ..ops.kernels.capillogue import cap_bundle, lbm_capillogue, lbm_capillogue_plain
from ..ops.kernels.capmac import (
    hcz_capillary_gradmac,
    hcz_capillary_gradmac_plain,
    slab_bundle,
)
from ..ops.kernels.contact3d import contact_angle_3d, contact_angle_3d_plain
from ..ops.kernels.fused_step import (
    ghost_planes,
    lbm_epilogue,
    lbm_epilogue_plain,
    lbm_prologue,
    lbm_prologue_plain,
)
from ..ops.kernels.poisson import (
    MAX_K,
    TRAIL_MAX_K,
    emit_ok,
    poisson_sweeps,
    poisson_sweeps_plain,
)
from ..ops.kernels.psi_halo import pack as pack_psi_band
from ..ops.kernels.psi_halo import psi_ghost_band, psi_ghost_band_plain
from ..ops.kernels.scalar_poisson import scalar_wavefront, scalar_wavefront_plain
from ..ops.kernels.stencil3d import (
    grad_fields,
    grad_fields_plain,
    laplacian_field,
    laplacian_field_plain,
)
from ..ops.kernels.stream3d import (
    stream_bounce_macro,
    stream_bounce_macro_plain,
    stream_bounce_moments,
    stream_bounce_moments_plain,
)
from ..ops.kernels.scalar_poisson import h2_from_psi_plain, scalar_h2
from ..ops.magnetic import h_int_from_psi, poisson_rhs_scaled
from ..ops.scalar_poisson import make_cmask, s_prev_from_h, scalar_from_h
from ..ops.stencils import substitute_obstacles, substitute_obstacles_slab
from .blocks import HALOS, WRAP, Blocks
from .halo import ring_halo
from .mesh import AXES, Mesh

__all__ = [
    "dp_dispatch",
    "on_slabs",
    "blocks3d",
    "check_block_grid",
    "solve_depth",
    "scalar_psi_blocks",
    "scalar_poisson_blocks",
    "channel_poisson_blocks",
    "sharded3d_ok",
    "fused_step_sharded_ok",
    "contact3d_sharded_ok",
    "capillogue_sharded_ok",
    "scalar_sharded_ok",
    "scalar_slab_plan",
    "channel_slab_plan",
    "channel_slab_rounds",
    "channel_sharded_ok",
    "global_shape",
    "unported",
    "fused_prologue_sharded",
    "scalar_poisson_sharded",
    "contact3d_sharded",
    "capillogue_sharded",
    "scalar_convert_sharded",
    "slab_clamp",
    "poisson_rhs_sharded",
    "laplacian_field_sharded",
    "capmac_sharded",
    "fused_epilogue_sharded",
    "psi_refresh_ok",
    "poisson_sweeps_sharded",
    "substitute_obstacles_sharded",
    "grad_fields_sharded",
    "stream_bounce_macro_sharded",
    "stream_bounce_moments_sharded",
]

def dp_dispatch(mesh: Mesh) -> bool:
    """True where each rank holds the whole grid of its batch elements and
    runs the single-device route: z, y and x axes of one rank, and no
    ``slab=True`` (JAX ``_dp_dispatch``)."""
    return mesh.nz * mesh.ny * mesh.nx == 1 and not mesh.slab


def on_slabs(mesh: Mesh, local_shape) -> bool:
    """Does a ferrofluid or HCZ state whose rank part has ``local_shape``
    ([B, C, Zl, Y, X]) step on the slab forms: a split grid (not
    :func:`dp_dispatch`) with z and batch axes only, one batch element a
    rank and slabs of 4 or more planes.  Else a split grid takes the block
    route (:func:`blocks3d`): two or more elements a rank take it on any
    split grid, a ``slab=True`` mesh too (the slab forms step one element,
    ROADMAP A12 slice 7b)."""
    return (not dp_dispatch(mesh) and mesh.ny * mesh.nx == 1 and local_shape[0] == 1
            and local_shape[2] >= 4)


def blocks3d(mesh: Mesh, f) -> Blocks:
    """This rank's :class:`~.blocks.Blocks` for a step of the 3D state whose
    f is ``f`` ([B_local, 19, bz, by, bx]) on the block route, any
    B_local: the ghosts, cuts and ops carry the batch axis, and each
    exchange moves every element's band.  A field is first extended at its
    first use's depth."""
    return Blocks(mesh, tuple(f.shape[2:]), min_depth=1)


def check_block_grid(blk: Blocks, f, plain: bool, ids=None) -> None:
    """Raise on the card without ``plain=True`` where a kernel that the step
    launches (``ids``, default all) would meet an extension shorter than
    its ``min_axis`` (4: B2, B5, B10a): a domain axis under it
    (``models/multiphase.py:check_kernel_grid``), or a block so thin along
    a split axis that its extension by one wrapped cell is."""
    from ..models.multiphase import check_kernel_grid
    from ..ops.kernels import KERNELS

    check_kernel_grid(f, plain, ids, grid=tuple(a[3] for a in blk.axes.values()))
    if plain or f.device.type != "cuda":
        return
    need = max(getattr(k.wrapper, "min_axis", 1) for kid, k in KERNELS.items()
               if ids is None or kid in ids)
    thin = [f"{a[0]}={a[1]}" for a in blk.split.values() if a[1] + 2 < need]
    if thin:
        raise ValueError(f"blocks of {', '.join(thin)} cells: the kernels on the block route "
                         f"need {need - 2} or more cells a rank along each split axis; use "
                         "fewer ranks there, or pass plain=True")


def global_shape(local_shape, mesh: Mesh) -> tuple:
    """The whole domain's [B, C, Z, Y, X] shape of a rank's block."""
    B, C, Z, Y, X = local_shape
    return (B * mesh.nb, C, Z * mesh.nz, Y * mesh.ny, X * mesh.nx)


def unported(route: str) -> NotImplementedError:
    """The error for a route of the meshed step that the port does not run
    on its mesh."""
    return NotImplementedError(
        f"{route} is not ported yet (ROADMAP A12); step it on one device, on a batch mesh, or "
        "on a mesh with a y or x axis (the block route)")


def sharded3d_ok(mesh: Mesh, shape) -> bool:
    """Can the slab path run this global [B, C, Z, Y, X] shape on ``mesh``?
    Only the batch and z axes larger than 1, one batch element a rank, and
    Z dividing into slabs of 2 or more planes (the ferrofluid and HCZ steps
    take the slab forms at 4 or more, :func:`on_slabs`)."""
    if len(shape) != 5:
        return False
    B, _, Z, _, _ = shape
    if mesh.ny * mesh.nx > 1 or any(size > 1 and name not in AXES
                                    for name, size in mesh.sizes.items()):
        return False
    if B % mesh.nb or B // mesh.nb != 1:
        return False
    return Z % mesh.nz == 0 and Z // mesh.nz >= 2


def fused_step_sharded_ok(mesh: Mesh, shape, kbc_type) -> bool:
    """B4's slab form: LBGK f and g of 19 channels, slabs of 4 or more
    planes."""
    return (kbc_type is None and len(shape) == 5 and shape[1] == 19
            and sharded3d_ok(mesh, shape) and shape[2] // mesh.nz >= 4)


def contact3d_sharded_ok(mesh: Mesh, shape, dtype) -> bool:
    """B2's slab form: float32 rho, slabs of 4 or more planes."""
    return (dtype == torch.float32 and sharded3d_ok(mesh, shape)
            and shape[2] // mesh.nz >= 4)


def capillogue_sharded_ok(mesh: Mesh, shape) -> bool:
    """B3's slab form: slabs of 4 or more planes."""
    return sharded3d_ok(mesh, shape) and shape[2] // mesh.nz >= 4


def slab_clamp(mesh: Mesh, Zl: int) -> tuple[int, int]:
    """The z clamp of a slab of ``Zl`` planes: 1 and Zl-2 at the domain's
    true edges, -1 and Zl where the slab has a neighbour."""
    return (1 if mesh.iz == 0 else -1, Zl - 2 if mesh.iz == mesh.nz - 1 else Zl)


#: a round's own cost in cell-sweeps of B1's passes, whatever its plane:
#: the copies of the extended pair, the exchanges and the launches (about
#: 0.25 ms a round on an H100 at 256^3 and at 130x66x130, chip_smoke.py
#: --scalar-plans)
ROUND_CELL_SWEEPS = 24_000_000


def scalar_slab_plan(mesh: Mesh, s2_shape, n_iters: int):
    """(k, G) of B1's slab rounds on the global [1, 2, Z, Y, X] carry, or
    None: k >= 2 divides ``n_iters`` with G = k + 1 <= Zl (one exchange
    brings at most a slab's planes; JAX ``_scalar_slab_plan`` without its
    VMEM gate).  Every such k computes the same sweeps; this one has the
    least ``n_iters / k * ROUND_CELL_SWEEPS + 2 n_iters (k + 1) Y X``,
    fewer rounds against fewer ghost planes swept: at 30 sweeps k = 15 on
    256^2 planes and k = 30 on 66x130, the fastest k at both grids
    (chip_smoke.py --scalar-plans)."""
    _, C, Z, Y, X = s2_shape
    if C != 2 or Z % mesh.nz:
        return None
    Zl = Z // mesh.nz
    ks = [k for k in range(2, n_iters + 1) if n_iters % k == 0 and k + 1 <= Zl]
    if not ks:
        return None
    k = min(ks, key=lambda k: n_iters // k * ROUND_CELL_SWEEPS + 2 * n_iters * (k + 1) * Y * X)
    return k, k + 1


def scalar_sharded_ok(mesh: Mesh, s2_shape, n_iters: int) -> bool:
    """Can B1 solve the global [B, 2, Z, Y, X] carry (B = nb: one element a
    rank) on ``mesh``: the single-device kernel under :func:`dp_dispatch`,
    else a slab plan."""
    if not sharded3d_ok(mesh, s2_shape):
        return False
    if dp_dispatch(mesh):
        return min(s2_shape[2:]) >= 3
    return scalar_slab_plan(mesh, s2_shape, n_iters) is not None


#: B11b's slab rounds on an NVIDIA H100 80GB HBM3 at a 700 W power limit:
#: a round's own cost (its two exchanges, its launch and its walk's start)
#: in ns, and a pass's cost in ns a cell of the Zl + 2k - 2 planes a block
#: walks, by its k sweeps: fitted to the slab solve's times at every k at
#: 256^3 and 130x66x130, float32 h, one rank (chip_smoke.py
#: --channel-slab-plans; k = 3 the fastest at both, and in bfloat16 within
#: 1.5 % of the fastest)
CHANNEL_ROUND_NS = 75_000
CHANNEL_PASS_NS = {1: 0.0734, 2: 0.0761, 3: 0.0974, 4: 0.194}


def channel_slab_plan(mesh: Mesh, h_shape, n_iters: int, h2: bool = False):
    """(k, G, r) of B11b's slab rounds on the global [1, 19, Z, Y, X] h, or
    None: ``n_iters // k`` rounds of one launch of k <= ``MAX_K`` sweeps
    with G = k <= Zl band planes a side (one exchange brings at most a
    slab's planes), then a remainder round of r = ``n_iters % k`` sweeps
    (0: none) that reads the nearest r planes of the same bands.  Every k
    computes the same sweeps; this one has the least cost by
    ``CHANNEL_ROUND_NS`` and ``CHANNEL_PASS_NS``.  The JAX package's
    ``params.poisson_halo_depth`` is not read: its depth was the TPU's
    VMEM stopping point.

    ``h2``: the last round also emits H2, which needs psi exact a plane
    past the slab: its k_f sweeps (r, or k) read G_f = k_f + 1 <= Zl band
    planes (JAX clamps its depth to Zl - 1 for the same reason, :1076-1093)
    and k_f <= ``TRAIL_MAX_K``, so a k whose last round breaks that is
    dropped (Zl = 3: k = 2; Zl = 2: k = 1); None also where the output has
    no interior cell in x or y (``poisson.emit_ok``).  The caller then
    takes the psi route."""
    _, C, Z, Y, X = h_shape
    if C != 19 or Z % mesh.nz:
        return None
    Zl = Z // mesh.nz
    ks = [k for k in range(1, min(MAX_K, n_iters) + 1) if k <= Zl]
    if h2:
        ks = [k for k in ks if (n_iters % k or k) + 1 <= min(Zl, TRAIL_MAX_K + 1)
              and emit_ok((Zl, Y, X), slab=True)]
    if not ks:
        return None

    def walk(k):
        return (Zl + 2 * k - 2) * Y * X * CHANNEL_PASS_NS[k]

    def cost(k):
        r = n_iters % k
        return (-(-n_iters // k) * CHANNEL_ROUND_NS + n_iters // k * walk(k)
                + (walk(r) if r else 0))

    k = min(ks, key=cost)
    return k, k, n_iters % k


def channel_slab_rounds(mesh: Mesh, h_shape, n_iters: int, h2: bool = False):
    """(rounds, depth, emitted) of the slab solve on the global [1, 19, Z,
    Y, X] h, or None without a plan: the sweeps of each round of
    :func:`channel_slab_plan` (with ``h2`` its trailing-stage plan where it
    admits one, ``emitted``), and the band planes a side each round reads:
    G, and G_f = k_f + 1 in the last round where it emits H2."""
    plan = channel_slab_plan(mesh, h_shape, n_iters, h2=True) if h2 else None
    emitted = plan is not None
    plan = plan or channel_slab_plan(mesh, h_shape, n_iters)
    if plan is None:
        return None
    k, G, r = plan
    rounds = [k] * (n_iters // k) + [r] * (r > 0)
    return rounds, [G] * (len(rounds) - 1) + [rounds[-1] + 1 if emitted else G], emitted


def channel_sharded_ok(mesh: Mesh, h_shape, n_iters: int) -> bool:
    """Can B11b solve the global [B, 19, Z, Y, X] h (B = nb: one element a
    rank) on ``mesh``: the single-device kernel under :func:`dp_dispatch`,
    else a slab plan."""
    if not sharded3d_ok(mesh, h_shape):
        return False
    return dp_dispatch(mesh) or channel_slab_plan(mesh, h_shape, n_iters) is not None


def _fg_ghosts(f, g, mesh: Mesh):
    """(f_lo, f_hi, g_lo, g_hi): the 5-channel planes of the neighbours that
    the pulls of the slab's edge planes read (``fused_step.ghost_planes``),
    f and g in one exchange a side."""
    f_up, f_dn = ghost_planes(f)
    g_up, g_dn = ghost_planes(g)
    lo = ring_halo(torch.cat([f_up, g_up], dim=1), mesh, +1)  # the rank below's top
    hi = ring_halo(torch.cat([f_dn, g_dn], dim=1), mesh, -1)  # the rank above's bottom
    return lo[:, :5], hi[:, :5], lo[:, 5:], hi[:, 5:]


def _extend(x, G: int, mesh: Mesh):
    """``x`` [B, C, Zl, Y, X] with the neighbours' G nearest planes a side."""
    lo = ring_halo(x[:, :, -G:], mesh, +1)
    hi = ring_halo(x[:, :, :G], mesh, -1)
    return torch.cat([lo, x, hi], dim=2)


def fused_prologue_sharded(f, g, flags, rho_old, vel_old, mesh: Mesh, *, c, rho_gas,
                           rho_fluid, density_gas, density_fluid, plain=False):
    """B4 on the rank's slab: the macros of the slab's planes."""
    prologue = lbm_prologue_plain if plain else lbm_prologue
    kw = dict(c=c, rho_gas=rho_gas, rho_fluid=rho_fluid, density_gas=density_gas,
              density_fluid=density_fluid)
    ghosts = None if dp_dispatch(mesh) else _fg_ghosts(f, g, mesh)
    return prologue(f, g, flags, rho_old, vel_old, ghosts, **kw)


def contact3d_sharded(rho, flags, contact_angle, mesh: Mesh, *, plain=False):
    """B2 on the rank's slab: one rho plane a side, the edge surgery on the
    domain's true edges only."""
    surgery = contact_angle_3d_plain if plain else contact_angle_3d
    if dp_dispatch(mesh):
        return surgery(rho, flags, contact_angle)
    ghosts = (ring_halo(rho[:, :, -1:], mesh, +1), ring_halo(rho[:, :, :1], mesh, -1))
    return surgery(rho, flags, contact_angle, ghosts, (mesh.iz == 0, mesh.iz == mesh.nz - 1))


def capillogue_sharded(f, g, flags, rho_pre, density_pre, pressure_old, rho_ca, H2, g_sum,
                       g_mom, vel_old, magnetic_flags, mesh: Mesh, *, kappa, gravity,
                       rho_gas, rho_fluid, density_gas, density_fluid, tau_f, tau_g, dx=1.0,
                       dt=1.0, emit_rhs, plain=False):
    """B3 on the rank's slab, the steady state's form (no force written):
    returns (f', g', vel, pressure, density, premac).  Exchanges: the f
    and g planes, one bundle a side of the capillary fields' planes
    (``capillogue.cap_bundle``: small planes, where an exchange's latency
    rivals its transfer), and the collided f'/g' planes between the
    collide and the emission."""
    capillogue = lbm_capillogue_plain if plain else lbm_capillogue
    kw = dict(kappa=kappa, gravity=gravity, rho_gas=rho_gas, rho_fluid=rho_fluid,
              density_gas=density_gas, density_fluid=density_fluid, tau_f=tau_f,
              tau_g=tau_g, dx=dx, dt=dt, emit_rhs=emit_rhs, emit_force=False)
    args = (f, g, flags, rho_pre, density_pre, pressure_old, rho_ca, H2, g_sum, g_mom,
            vel_old, magnetic_flags)
    if dp_dispatch(mesh):
        return capillogue(*args, **kw)
    fields = (rho_pre, density_pre, pressure_old, rho_ca, flags)
    cap = (ring_halo(cap_bundle(*fields, "lo"), mesh, +1),
           ring_halo(cap_bundle(*fields, "hi"), mesh, -1))
    return capillogue(*args, _fg_ghosts(f, g, mesh), cap, slab_clamp(mesh, f.shape[2]),
                      lambda fn, gn: _fg_ghosts(fn, gn, mesh), **kw)


def poisson_rhs_sharded(phi, magnetic_flags, mesh: Mesh, h_ext, *, tau, dx=1.0, dt=1.0):
    """``ops/magnetic.py:poisson_rhs_scaled`` on the rank's slab.  An
    in-plane field's source is local; an out-of-plane field's (``h_ext``
    along z) takes a z-staggered difference of chi, which reads phi at
    z -+ 1 and is zero at the domain's edge planes: phi comes with the
    neighbours' edge planes (one exchange a side) on each side that has a
    neighbour, and nothing on a true edge, so that its planes take the
    zero as on the whole domain."""
    kw = dict(tau=tau, dx=dx, dt=dt)
    if dp_dispatch(mesh) or float(h_ext[2]) == 0.0:
        return poisson_rhs_scaled(phi, magnetic_flags, h_ext, **kw)
    Zl = phi.shape[2]
    lo = ring_halo(phi[:, :, -1:], mesh, +1)
    hi = ring_halo(phi[:, :, :1], mesh, -1)
    zlo, zhi = slab_clamp(mesh, Zl)
    below, above = zlo < 0, zhi >= Zl
    phi_x = torch.cat([lo] * below + [phi] + [hi] * above, dim=2)
    m_x = torch.cat([magnetic_flags[:, :, :1]] * below + [magnetic_flags]
                    + [magnetic_flags[:, :, -1:]] * above, dim=2)
    return poisson_rhs_scaled(phi_x, m_x, h_ext, **kw)[:, :, int(below):int(below) + Zl]


def laplacian_field_sharded(field, mesh: Mesh, *, dx=1.0, density_of=None, plain=False):
    """B10b on the rank's slab: one plane a side of ``field``, the zero ring
    at the domain's true edges only (JAX ``laplacian_field_sharded``, whose
    masked fix the clamp does in the kernel); with ``density_of`` the
    Laplacian of the density map of ``field`` (rho), as B6 builds it."""
    lap = laplacian_field_plain if plain else laplacian_field
    kw = dict(dx=dx, density_of=density_of)
    if dp_dispatch(mesh):
        return lap(field, **kw)
    ghosts = (ring_halo(field[:, :, -1:], mesh, +1), ring_halo(field[:, :, :1], mesh, -1))
    return lap(field, ghosts, slab_clamp(mesh, field.shape[2]), **kw)


def capmac_sharded(lap, rho_pre, density_pre, pressure, rho_ca, H2, phi, flags, g_sum, g_mom,
                   vel_old, mesh: Mesh, *, kappa, gravity, rho_gas, rho_fluid, density_gas,
                   density_fluid, dx=1.0, dt=1.0, plain=False):
    """B6 on the rank's slab -> (vel, pressure, force, dfai, dprho): ``lap``
    (:func:`laplacian_field_sharded` of rho_ca with its density map) an input, one
    bundle a side of the stencil fields' edge planes (lap, rho_pre,
    density_pre, pressure, flags and, with ``H2``, phi), the z clamp at the
    domain's true edges only (JAX ``capmac_sharded``).  Under
    :func:`dp_dispatch` the single-device kernel, which builds the
    Laplacian itself (``lap`` unused)."""
    capillary = hcz_capillary_gradmac_plain if plain else hcz_capillary_gradmac
    kw = dict(kappa=kappa, gravity=gravity, rho_gas=rho_gas, rho_fluid=rho_fluid,
              density_gas=density_gas, density_fluid=density_fluid, dx=dx, dt=dt)
    args = (rho_pre, density_pre, pressure, rho_ca, H2, phi, flags, g_sum, g_mom, vel_old)
    if dp_dispatch(mesh):
        return capillary(*args, **kw)
    fields = (lap, rho_pre, density_pre, pressure, flags, phi)
    ghosts = (ring_halo(slab_bundle(*fields, "lo"), mesh, +1),
              ring_halo(slab_bundle(*fields, "hi"), mesh, -1))
    return capillary(*args, lap, ghosts, slab_clamp(mesh, rho_pre.shape[2]), **kw)


def fused_epilogue_sharded(f, g, flags, rho, vel, density, pressure, force, dfai, dprho,
                           mesh: Mesh, *, tau_f, tau_g, dx=1.0, dt=1.0, emit_mac=False,
                           mac_consts=None, plain=False):
    """B5 on the rank's slab -> (f', g') or, with ``emit_mac``, (f', g',
    mac): the f and g planes its pulls cross the faces for, and with
    ``emit_mac`` the collided edge planes exchanged before B4's slab form
    emits every plane's macros (the JAX wrapper rebuilds the two edge
    planes' in jnp, ``_mac_plane_jnp``)."""
    epilogue = lbm_epilogue_plain if plain else lbm_epilogue
    kw = dict(tau_f=tau_f, tau_g=tau_g, dx=dx, dt=dt, emit_mac=emit_mac,
              mac_consts=mac_consts)
    args = (f, g, flags, rho, vel, density, pressure, force, dfai, dprho)
    if dp_dispatch(mesh):
        return epilogue(*args, **kw)
    emit = (lambda fn, gn: _fg_ghosts(fn, gn, mesh)) if emit_mac else None
    return epilogue(*args, _fg_ghosts(f, g, mesh), emit, **kw)


def _sliver_planes(mesh: Mesh, Zl: int, G: int, shift: int, sender: bool) -> list:
    """The positions in a band of G planes travelling ``shift`` (+1: the
    sender's top G planes, -1: its bottom G) of the planes whose global z
    is 1 and Z - 2 (None where the band holds none), as the sender
    (``sender``) or the receiver counts them: the same on both sides."""
    iz = mesh.iz if sender else mesh.iz - shift
    first = iz * Zl + (Zl - G if shift > 0 else 0)
    Z = Zl * mesh.nz
    at = {(first + g) % Z: g for g in range(G)}
    return [at.get(1), at.get(Z - 2)]


def _sliver_xchg(band, mesh: Mesh, shift: int, Zl: int):
    """:func:`~.halo.ring_halo` of an (s, s_prev) band [1, 2, G, Y, X]
    under the shell sliver (JAX ``band_xchg`` :1492-1538): s whole, s_prev
    as its columns x = 1, X - 2 and two planes, those of global z 1 and Z -
    2 (zeros where the band holds neither: every rank sends as many bytes
    as it receives), in one exchange; the receiver zero-fills the rest of
    s_prev, which a sweep reads only where cmask > 0 (cells next to the
    shell's obstacles)."""
    _, _, G, Y, X = band.shape
    zero = band.new_zeros((1, Y, X))
    planes = [zero if g is None else band[:, 1, g] for g in
              _sliver_planes(mesh, Zl, G, shift, True)]
    got = ring_halo(torch.cat([band[:, 0].reshape(-1), band[:, 1][..., [1, X - 2]].reshape(-1),
                               *(p.reshape(-1) for p in planes)]), mesh, shift)
    n, nc = G * Y * X, 2 * G * Y
    sp = torch.zeros((1, G, Y, X), dtype=band.dtype, device=band.device)
    for i, g in enumerate(_sliver_planes(mesh, Zl, G, shift, False)):
        if g is not None:
            sp[:, g] = got[n + nc + i * Y * X:n + nc + (i + 1) * Y * X].view(1, Y, X)
    cols = got[n:n + nc].view(1, G, Y, 2)
    sp[..., 1], sp[..., X - 2] = cols[..., 0], cols[..., 1]
    return torch.stack([got[:n].view(1, G, Y, X), sp], dim=1)


def scalar_poisson_sharded(s2, cmask, rhs_scaled, mesh: Mesh, *, n_iters, dx=1.0, h_ext,
                           plain=False, shell_sliver=False):
    """B1 on the rank's slab; returns (H2, s2').  ``n_iters / k`` rounds of
    k sweeps on the slab with G = k + 1 ghost planes a side
    (:func:`scalar_slab_plan`), read in place: the G-plane bands of (cmask,
    rhs) are exchanged once (one exchange a side) and passed beside the
    slab's own (``aux_ghosts``), the bands of (s, s_prev) are exchanged
    before each round (taken from the previous round's output, never from
    its input), and the last round emits H2 with the z clamp at the
    domain's true edges only.

    ``shell_sliver`` (the caller holds the ``mag_flags_shell``
    declaration; JAX ``shell_sliver`` :1428-1439): every band travels as
    :func:`_sliver_xchg`'s sliver, about half the bytes, the same bits up
    to the sign of a zero."""
    wavefront = scalar_wavefront_plain if plain else scalar_wavefront
    if dp_dispatch(mesh):
        s2o, h2 = wavefront(s2, cmask, rhs_scaled, n_iters=n_iters, emit="h2", dx=dx,
                            h_ext=h_ext)
        return h2, s2o
    plan = scalar_slab_plan(mesh, global_shape(s2.shape, mesh), n_iters)
    if plan is None:
        raise ValueError("no slab plan for B1: gate on scalar_sharded_ok")
    k, G = plan
    Zl = s2.shape[2]
    Ze = Zl + 2 * G

    def xchg(band, shift):
        if shell_sliver:
            return _sliver_xchg(band, mesh, shift, Zl)
        return ring_halo(band, mesh, shift)

    aux = (ring_halo(torch.cat([cmask[:, :, -G:], rhs_scaled[:, :, -G:]], dim=1), mesh, +1),
           ring_halo(torch.cat([cmask[:, :, :G], rhs_scaled[:, :, :G]], dim=1), mesh, -1))
    clamp = (G + 1 if mesh.iz == 0 else 1, G + Zl - 2 if mesh.iz == mesh.nz - 1 else Ze - 2)
    bands = (xchg(s2[:, :, -G:], +1), xchg(s2[:, :, :G], -1))
    for _ in range(n_iters // k - 1):
        s2, (blo, bhi) = wavefront(s2, cmask, rhs_scaled, n_iters=k, emit=None, ghosts=bands,
                                   emit_bands=True, aux_ghosts=aux)
        bands = (xchg(bhi, +1), xchg(blo, -1))
    s2, h2 = wavefront(s2, cmask, rhs_scaled, n_iters=k, emit="h2", dx=dx, h_ext=h_ext,
                       ghosts=bands, slab_clamp=clamp, aux_ghosts=aux)
    return h2, s2


def scalar_convert_sharded(h, magnetic_flags, mesh: Mesh):
    """(s2, cmask) of the scalar carry from the channel h of the rank's slab
    (``models/ferrofluid.py:_scalar_convert``): the conversion and the wall
    weights read one plane across the slab's faces, so they run on the
    slab extended by the neighbours' planes."""
    if dp_dispatch(mesh):
        hx, mx = h, magnetic_flags
    else:
        hx, mx = _extend(h, 1, mesh), _extend(magnetic_flags, 1, mesh)
    s = scalar_from_h(hx, mx)
    sp = s_prev_from_h(hx, mx)
    s2, cmask = torch.cat([s, sp], dim=1).to(torch.float32), make_cmask(mx)
    if dp_dispatch(mesh):
        return s2, cmask
    return s2[:, :, 1:-1].contiguous(), cmask[:, :, 1:-1].contiguous()


def _flags_rhs_bands(flags, rhs, G: int, mesh: Mesh):
    """The neighbours' G nearest planes of the flags and the source,
    ((flags, rhs) below, (flags, rhs) above): one exchange a side of those
    planes alone (the flags travel as values of the source's type, which
    holds them exactly), the slab's own planes left where they are."""
    def side(planes, shift):
        got = ring_halo(torch.cat([flags[:, :, planes].to(rhs.dtype), rhs[:, :, planes]], dim=1),
                        mesh, shift)
        return got[:, :1].to(flags.dtype), got[:, 1:]

    return side(slice(-G, None), +1), side(slice(None, G), -1)


def _edge_bands(h, G: int, mesh: Mesh):
    """The neighbours' G nearest planes of ``h`` a side: (below, above)."""
    return ring_halo(h[:, :, -G:], mesh, +1), ring_halo(h[:, :, :G], mesh, -1)


def psi_refresh_ok(tau, G: int, Zl: int) -> bool:
    """Can a band of G planes of a slab of Zl planes be rebuilt from the
    neighbour's psi (ROADMAP B-8, JAX ``body_psi`` :1155-1163): tau == 1
    (the stored h a function of psi and the source) and 2 <= G < Zl (at G
    == Zl the outermost plane can be a z-edge plane of the domain, whose
    obstacles psi cannot give; one plane is the full exchange).  The
    caller also holds the ``mag_flags_shell`` declaration."""
    return float(tau) == 1.0 and 2 <= G < Zl


def _psi_bands(h, psi, aux, G: int, mesh: Mesh, plain: bool):
    """The neighbours' G-plane bands of the next round rebuilt from their
    psi (:mod:`~..ops.kernels.psi_halo`): one exchange a side of the packed
    psi planes, innermost plane and x-edge columns, then
    ``psi_ghost_band`` with the source planes under each band's outer
    planes, taken from the source's bands in ``aux``
    (:func:`_flags_rhs_bands`)."""
    band = psi_ghost_band_plain if plain else psi_ghost_band
    Y, X = h.shape[3:]
    lo = ring_halo(pack_psi_band(h, psi, G, "lo"), mesh, +1)  # the rank below's top
    hi = ring_halo(pack_psi_band(h, psi, G, "hi"), mesh, -1)  # the rank above's bottom
    r_lo, r_hi = aux[0][1], aux[1][1]
    G_ext = r_lo.shape[2]
    kw = dict(G=G, Y=Y, X=X, dtype=h.dtype)
    return (band(lo, r_lo[:, :, G_ext - G:G_ext - 1], band="lo", **kw),
            band(hi, r_hi[:, :, 1:G], band="hi", **kw))


def poisson_sweeps_sharded(h, magnetic_flags, rhs_scaled, mesh: Mesh, *, tau, n_iters,
                           plain=False, emit_h2=None, dx=1.0, psi_halo=False):
    """B11b on the rank's slab; returns (h', psi of the last sweep).  Rounds
    of :func:`channel_slab_plan`: each one launch of the slab form, which
    reads h in place and its two G-plane bands through their own pointers
    (the TPU wavefront's ghost-ref mode, JAX ``poisson_sweeps_sharded``
    :1181-1250); the first round's bands are the incoming h's edge planes,
    each later round's those the round before it emitted.  The flags and
    rhs stay the caller's tensors: their bands of the deepest round's
    planes are exchanged once (:func:`_flags_rhs_bands`, one exchange a
    side) and every round reads them beside the slab's in place
    (``aux_ghosts``).  Under :func:`dp_dispatch` the single-device call.

    ``emit_h2`` (the static field's 3 components): returns (h', H2, True)
    where the plan with ``h2=True`` admits it, the last round's trailing
    stage emitting H2 with the z clamp at the domain's true edges only
    (:func:`slab_clamp`) from bands of G_f = k_f + 1 planes of h'
    (JAX exchanges k + 1 planes every round, :1083-1093), the flags and
    rhs bands max(G, G_f) planes deep; else (h', psi, False), psi for the caller's
    substitution and gradient (JAX's fall-through).

    ``psi_halo`` (the caller holds the ``mag_flags_shell`` declaration;
    JAX ``psi_halo`` :1039-1046): each round after the first whose bands
    :func:`psi_refresh_ok` admits reads bands rebuilt from the round
    before's psi (:func:`_psi_bands`; that round emits psi, not bands),
    the final h2 round's G_f planes too: the same exchanges, fewer bytes,
    the same bits as the full-h bands."""
    sweeps = poisson_sweeps_plain if plain else poisson_sweeps
    if dp_dispatch(mesh):
        if emit_h2 is None:
            return sweeps(h, magnetic_flags, rhs_scaled, tau=tau, n_iters=n_iters)
        emitted = emit_ok(h.shape)
        kw = dict(emit="h2", dx=dx, h_ext=emit_h2) if emitted else {}
        return (*sweeps(h, magnetic_flags, rhs_scaled, tau=tau, n_iters=n_iters, **kw),
                emitted)
    planned = channel_slab_rounds(mesh, global_shape(h.shape, mesh), n_iters,
                                  h2=emit_h2 is not None)
    if planned is None:
        raise ValueError("no slab plan for B11b: gate on channel_sharded_ok")
    rounds, depth, emitted = planned
    # G: the plan's band planes (depth[0] wherever a round before the last
    # or a last round without the trailing stage reads it)
    G, Zl = depth[0], h.shape[2]
    aux = _flags_rhs_bands(magnetic_flags, rhs_scaled, max(depth), mesh)
    fields = (magnetic_flags, rhs_scaled)
    bands = _edge_bands(h, depth[0], mesh)
    for kk, g in zip(rounds[:-1], depth[1:]):
        refresh = psi_halo and psi_refresh_ok(tau, g, Zl)
        # the kernel emits the next round's bands where they are G planes
        # of h; G_f planes of h are sliced from h'
        emit_bands = g == G and not refresh
        out = sweeps(h, *fields, tau=tau, n_iters=kk, ghosts=bands, emit_bands=emit_bands,
                     emit_psi=refresh, aux_ghosts=aux)
        h = out[0]
        if refresh:
            bands = _psi_bands(h, out[1], aux, g, mesh, plain)
        elif emit_bands:
            bands = (ring_halo(out[2][1], mesh, +1), ring_halo(out[2][0], mesh, -1))
        else:
            bands = _edge_bands(h, g, mesh)
    if emitted:
        h, h2 = sweeps(h, *fields, tau=tau, n_iters=rounds[-1], ghosts=bands, emit="h2", dx=dx,
                       h_ext=emit_h2, clamp=slab_clamp(mesh, Zl), aux_ghosts=aux)
        return h, h2, True
    out = sweeps(h, *fields, tau=tau, n_iters=rounds[-1], ghosts=bands, aux_ghosts=aux)
    return (*out, False) if emit_h2 is not None else out


def substitute_obstacles_sharded(x, magnetic_flags, mesh: Mesh):
    """The gradient's obstacle substitution on the rank's slab
    (``ops/stencils.py:substitute_obstacles_slab``): local, its z pad at the
    domain's true edges only, as the JAX package pads the whole domain
    outside ``shard_map`` (``ops/magnetic.py`` :466-475 there)."""
    if dp_dispatch(mesh):
        return substitute_obstacles(x, magnetic_flags)
    return substitute_obstacles_slab(x, magnetic_flags, (mesh.iz == 0, mesh.iz == mesh.nz - 1))


def grad_fields_sharded(fields, mesh: Mesh, *, dx=1.0, plain=False):
    """B10a on the rank's slab: one plane of each field a side, the output
    ring replicated in x and y on every slab and in z at the domain's true
    edges only (JAX ``grad_fields_sharded`` :1601-1628, whose fix the clamp
    does in the kernel)."""
    grad = grad_fields_plain if plain else grad_fields
    if dp_dispatch(mesh):
        return grad(fields, dx=dx)
    ghosts = (ring_halo(fields[:, :, -1:], mesh, +1), ring_halo(fields[:, :, :1], mesh, -1))
    return grad(fields, ghosts, slab_clamp(mesh, fields.shape[2]), dx=dx)


def _stream_ghosts(f, mesh: Mesh):
    """The 5-channel planes of the neighbours that the pulls of the slab's
    edge planes read (``fused_step.ghost_planes``), one exchange a side."""
    up, dn = ghost_planes(f)
    return ring_halo(up, mesh, +1), ring_halo(dn, mesh, -1)


def stream_bounce_macro_sharded(f, flags, rho_old, vel_old, mesh: Mesh, *, c, rho_gas,
                                rho_fluid, density_gas, density_fluid, plain=False):
    """B8b on the rank's slab (JAX ``stream_bounce_macro_sharded`` :151)."""
    macro = stream_bounce_macro_plain if plain else stream_bounce_macro
    kw = dict(c=c, rho_gas=rho_gas, rho_fluid=rho_fluid, density_gas=density_gas,
              density_fluid=density_fluid)
    ghosts = None if dp_dispatch(mesh) else _stream_ghosts(f, mesh)
    return macro(f, flags, rho_old, vel_old, ghosts, **kw)


def stream_bounce_moments_sharded(g, flags, mesh: Mesh, *, plain=False):
    """B8a on the rank's slab (JAX ``stream_bounce_moments_sharded``
    :129)."""
    moments = stream_bounce_moments_plain if plain else stream_bounce_moments
    return moments(g, flags, None if dp_dispatch(mesh) else _stream_ghosts(g, mesh))


# ---------------------------------------------------------------- block route
def solve_depth(blk: Blocks, n_iters: int) -> int:
    """The ghost depth of the solve's flags, cmask and source on the block
    route: the deepest round's, the last with the tail's clamp depth
    (``HALOS[scalar_h2]``, ``HALOS[h_int_from_psi]``: 3) added so that psi
    is exact that far past the block."""
    rounds = blk.rounds(n_iters)
    return max(max(rounds), rounds[-1] + HALOS[scalar_h2][1])


def _rounds(blk: Blocks, sweeps, x, aux, n_iters, **kw):
    """The sweeps of a solve on the rank's block in rounds
    (:meth:`~.blocks.Blocks.rounds`): each round extends the carried ``x``
    by k wrapped ghost cells (the last by k + 3) and runs k sweeps of
    ``sweeps(x, *aux, n_iters=k, **kw)`` on it, whose wrap reaches only
    ghost cells; ``aux`` (flags or cmask, and the source) is extended once.
    Returns (x', psi of the last sweep, its ghosts exact 3 cells deep)."""
    tail = HALOS[scalar_h2][1]
    rounds = blk.rounds(n_iters)
    blk.extend(list(aux), solve_depth(blk, n_iters))
    for i, k in enumerate(rounds):
        g = k + tail if i == len(rounds) - 1 else k
        ext = blk.extend([x, *aux], g)
        out, psi = sweeps(*ext, n_iters=k, **kw)
        x = blk.cut(out, g, WRAP)
    return x, blk.adopt(psi, g, tail)


def scalar_psi_blocks(blk: Blocks, s2, cmask, rhs_scaled, *, n_iters, plain=False):
    """B1's passes on the rank's block in rounds
    (``scalar_wavefront(..., emit="psi")``); returns (psi, s2'), psi
    adopted with ghosts exact 3 cells deep (``Blocks.adopt``), from which
    an H2 launch under the clamp rule cuts its ghosts."""
    wavefront = scalar_wavefront_plain if plain else scalar_wavefront
    s2, psi = _rounds(blk, wavefront, s2, (cmask, rhs_scaled), n_iters, emit="psi")
    return psi, s2


def scalar_poisson_blocks(blk: Blocks, s2, cmask, rhs_scaled, *, n_iters, dx=1.0, h_ext,
                          plain=False):
    """B1 on the rank's block; returns (H2, s2').  The passes in rounds
    (:func:`scalar_psi_blocks`), then B1's H2 launch (``scalar_h2``) on psi
    and cmask extended by 3 cells under the clamp rule, cut from their wrap
    extensions, so that the gradient's ring and obstacle substitution meet
    the domain's true faces."""
    psi, s2 = scalar_psi_blocks(blk, s2, cmask, rhs_scaled, n_iters=n_iters, plain=plain)
    h2 = h2_from_psi_plain if plain else scalar_h2
    return blk.op(h2)(psi, cmask, float(dx), tuple(float(v) for v in h_ext)), s2


def channel_poisson_blocks(blk: Blocks, h, magnetic_flags, rhs_scaled, *, tau, n_iters,
                           dx=1.0, h2_ext=None, plain=False):
    """B11b on the rank's block; returns (H_int, or H2 with ``h2_ext``,
    h').  The passes in rounds, the last emitting psi, then the psi route
    (``ops/magnetic.py:h_int_from_psi``: the obstacle substitution and
    B10a) on psi and the flags extended by 3 cells under the clamp rule, as
    one device's ``solve_H_int`` runs it where B7's trailing stage does
    not apply (the trailing stage mixes the sweeps' wrap with the
    gradient's clamp).  Two or more elements a rank run in each launch:
    B11b's batch instances, B10a's batch form."""
    sweeps = poisson_sweeps_plain if plain else poisson_sweeps
    h, psi = _rounds(blk, sweeps, h, (magnetic_flags, rhs_scaled), n_iters, tau=tau)
    grad = grad_fields_plain if plain else grad_fields
    return blk.op(h_int_from_psi)(psi, magnetic_flags, dx=dx, h2_ext=h2_ext, grad=grad), h
