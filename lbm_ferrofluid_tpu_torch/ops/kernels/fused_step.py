"""B4 and B5: the prologue and the epilogue of the un-fused ferrofluid step.

B4, the prologue, replaces the TPU kernel ``lbm_ferrofluid_tpu/ops/pallas/
fused_step.py:lbm_prologue`` (:721): stream + bounce of f and g straight to
the macro fields.  The CUDA source is ``csrc/fused_step.cu``, whose entry
point the capillogue's and the epilogue's emissions launch too: one thread
per cell pulls 19 + 19 values with periodic wrap on every axis, bounces them
at obstacles and writes rho (frozen at obstacles), vel, density, m0g and
m1g.  A call is one launch.  The plain version is
``ops/stream.py:stream_bounce_macro`` + ``stream_bounce_moments``.  Bound on
an H100: bytes, 189 B per cell plus 16 B per obstacle cell (read f, g and
flags everywhere, rho_old and vel_old at obstacles; write 9 channels):
0.948 ms at 256^3 over 3.35 TB/s; 113 B per cell plus 16 B per obstacle
cell, 0.57 ms, with f and g stored in bfloat16.

B5, the epilogue, replaces the TPU kernel ``lbm_epilogue`` (:779): re-stream
+ bounce of f and g and the HCZ collide with the capillary stage's macro
fields, out of place into a new f/g pair, and with ``emit_mac`` the next
step's macros from f'/g' (the TPU kernel's trailing in-kernel stage).  The
step's launch is the stage form (``csrc/fused_step.cu``): a block owns
``NT`` consecutive cells of a plane, one thread a cell, and walks a strip of
zb planes (``plan``); at each plane a thread copies all its loads into
shared memory by cp.async, then collides.  With ``emit_mac`` the prologue's
launch on f'/g' follows (two launches).  :data:`CELL`, the
one-thread-a-cell kernel, exists for ``chip_smoke.py``'s checks and plan
sweep only.
The plain version is ``hcz_collide(bounce_back(stream(.)))`` then
:func:`lbm_prologue_plain` on f'/g'.  Bound on an H100: bytes, B9's 305 B
per cell plus 60 B per fluid cell (153 B and 60 B in bfloat16 storage),
and with ``emit_mac`` 36 B per cell plus 16 B per obstacle cell more (see
:func:`cost_epilogue`).

B4's slab form (``ghosts=``, the TPU kernel's ghost mode, for a z-slab of a
domain decomposed along z over ranks: ``parallel/step3d.py``) pulls the
z-1 channels of plane 0 and the z+1 channels of plane Z-1 from the
neighbours' edge planes instead of the wrap: ``ghosts = (f_lo, f_hi, g_lo,
g_hi)``, each [1, 5, 1, Y, X] in the storage type, channels 9:14 of the
plane below the slab and 14:19 of the plane above (:func:`ghost_planes`),
which is all a pull reads there.  One launch (``launches_slab``); its plain
version streams the slab extended by those planes.

B5's slab form (``ghosts=`` and, with ``emit_mac``, ``emit_ghosts=``) is
the stage form whose plane 0 and plane Z-1 pull across the slab's faces
from the same 5-channel ghost planes; between its launch and the emission
``emit_ghosts(f', g')`` returns the neighbours' collided edge planes (the
caller's exchange), and the emission is B4's slab form on them, so every
plane's macros come from the kernels (the TPU's wrapper rebuilds the two
edge planes' in jnp).  One launch, two with ``emit_mac``
(``launches_slab``); its plain version streams f and g extended by their
ghosts, collides the slab, and emits through B4's plain slab form.

Both take a batch ``[B, 19, Z, Y, X]`` in one launch (B5's plan is an
element's; each element's bits are those of a call on it alone); their
slab forms take one element.

Both take f and g in float32 or bfloat16 (the JAX package's turbo mode):
the CUDA kernels' bfloat16 instances widen what they pull, compute in
float32 and round f'/g' once, on the store, and the emission reads the
stored bfloat16 f'/g'.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ...lattice import D3Q19
from ...utils.types import CellType
from ..collide import hcz_collide
from ..stream import bounce_back, stream, stream_bounce_macro, stream_bounce_moments
from ._lib import (STORAGE, call, check_batch, check_cuda, check_no_grad, count_launch,
                   elem_bytes, ptr, stream_of)

__all__ = [
    "lbm_prologue", "lbm_prologue_plain", "cost", "cost_slab", "stream_macro_launch",
    "ghost_planes", "extend_ghosts", "repeat_ends",
    "lbm_epilogue", "lbm_epilogue_plain", "cost_epilogue", "cost_epilogue_slab", "plan",
    "EpiloguePlan", "CELL",
    "FORMS",
]

TPU_KERNEL = "lbm_ferrofluid_tpu/ops/pallas/fused_step.py:721"
TPU_KERNEL_EPILOGUE = "lbm_ferrofluid_tpu/ops/pallas/fused_step.py:779"
CUDA_SOURCE = "lbm_ferrofluid_tpu_torch/csrc/fused_step.cu"
#: the forms of B5's kernel, by the index ``lbm_epilogue`` takes: one
#: thread a cell, and the step's, whose threads copy a plane's loads
#: into shared memory by cp.async before they collide (``csrc/fused_step.cu``)
FORMS = ("cell", "stage")
#: cells a block of the stage form owns, consecutive in a plane, and the
#: words of a thread's stage: ``EP_NT`` and ``EP_WORDS`` of
#: ``csrc/fused_step.cu``
NT = 256
STAGE_WORDS = 55
#: the longest strip ``plan`` considers in bfloat16 storage and a strip's
#: start-up in cell planes (float32 walks one plane a block): from
#: ``chip_smoke.py --epilogue-plans``
MAX_STRIP = 4
STRIP_START = 0.05


class EpiloguePlan(NamedTuple):
    """A launch's form (one of ``FORMS``) and, for the stage form, its
    strip of zb planes a block.  :data:`CELL` is one thread a cell."""

    form: str
    zb: int


#: the one-thread-a-cell kernel (``lbm_epilogue_kernel``):
#: ``chip_smoke.py``'s comparisons and plan sweep select it, the step never
#: does
CELL = EpiloguePlan("cell", 0)

#: registers a thread the launch bounds leave: ``EP_REGS``
REGS = 128


def blocks_per_sm(threads: int) -> int:
    """Resident blocks an SM, as the launch bounds ask room for: 65536
    registers over ``REGS`` a thread of a block of ``threads``."""
    return 65536 // (REGS * threads)


@functools.lru_cache(maxsize=None)
def plan(Z: int, Y: int, X: int, sms: int, bf16: bool) -> EpiloguePlan:
    """The step's plan on a Z x Y x X grid on a card of ``sms`` SMs, in
    either mode (with ``emit_mac`` the prologue's launch follows): the
    stage form with ``NT`` cells a block, one plane a block in float32,
    and in bfloat16 storage the strip up to ``MAX_STRIP`` with the fewest
    waves of resident blocks times planes a block (its strip and
    start-up).  Cached: the wrapper asks for it at every call."""
    if not bf16:
        return EpiloguePlan("stage", 1)
    blocks = -(-X * Y // NT)
    resident = sms * blocks_per_sm(NT)

    def ticks(zb):
        return -(-blocks * -(-Z // zb) // resident) * (zb + STRIP_START)

    return EpiloguePlan("stage", min(range(1, min(Z, MAX_STRIP) + 1), key=ticks))


def cost(f, g, flags, rho_old, vel_old, **_) -> tuple[int, int]:
    """(bytes, flops) that a call on these inputs must move and do: f, g
    (in their storage type) and flags read at every cell, rho_old and
    vel_old only at obstacles, 9 float channels written; m0g/m1g (48 flops)
    and the density map (3) at every cell, m0f/m1f (48) and vel (1 divide,
    3 multiplies) elsewhere."""
    n = flags.numel()
    n_obs = int((flags == int(CellType.OBSTACLE)).sum())
    fg = 19 * (elem_bytes(f) + elem_bytes(g))
    return n * (fg + 1 + 36) + 16 * n_obs, n * 51 + (n - n_obs) * 52


def cost_slab(f, g, flags, rho_old, vel_old, ghosts=None, **_) -> tuple[int, int]:
    """:func:`cost` of the slab form: the ghost planes' 5 channels of f and
    g a side read once more."""
    nbytes, flops = cost(f, g, flags, rho_old, vel_old)
    plane = flags.shape[-2] * flags.shape[-1]
    return nbytes + 2 * 5 * plane * (elem_bytes(f) + elem_bytes(g)), flops


def ghost_planes(f):
    """The planes of ``f`` [1, 19, Z, Y, X] that the neighbours of its slab
    pull: (channels 9:14 of plane Z-1, channels 14:19 of plane 0), each
    [1, 5, 1, Y, X].  The rank above takes the first as its ``lo`` ghost,
    the rank below the second as its ``hi``."""
    return f[:, 9:14, -1:], f[:, 14:19, :1]


def repeat_ends(x):
    """``x`` with its first and last planes repeated once outside: the
    planes around a slab whose values no kept output reads."""
    return torch.cat([x[:, :, :1], x, x[:, :, -1:]], dim=2)


def extend_ghosts(f, lo, hi):
    """``f`` [1, 19, Z, Y, X] with one plane a side: ``lo``'s channels at
    9:14 of plane -1, ``hi``'s at 14:19 of plane Z, zeros elsewhere (no pull
    of the slab's planes reads them)."""
    B, Q, Z, Y, X = f.shape
    plane = torch.zeros((B, Q, 1, Y, X), dtype=f.dtype, device=f.device)
    below, above = plane.clone(), plane
    below[:, 9:14] = lo
    above[:, 14:19] = hi
    return torch.cat([below, f, above], dim=2)


def lbm_prologue_plain(f, g, flags, rho_old, vel_old, ghosts=None, *, c, rho_gas, rho_fluid,
                       density_gas, density_fluid):
    """Plain PyTorch version of :func:`lbm_prologue`.  The slab form streams
    f and g extended by their ghost planes (:func:`extend_ghosts`) and keeps
    the slab's planes; the extension's planes hold any flags and old
    macros, since their outputs are dropped."""
    if ghosts is not None:
        f_lo, f_hi, g_lo, g_hi = ghosts
        out = lbm_prologue_plain(
            extend_ghosts(f, f_lo, f_hi), extend_ghosts(g, g_lo, g_hi), repeat_ends(flags),
            repeat_ends(rho_old), repeat_ends(vel_old), c=c, rho_gas=rho_gas,
            rho_fluid=rho_fluid, density_gas=density_gas, density_fluid=density_fluid,
        )
        return tuple(x[:, :, 1:-1] for x in out)
    _, rho, vel, density = stream_bounce_macro(
        D3Q19, f, flags, rho_old, vel_old, c=c, rho_gas=rho_gas,
        rho_fluid=rho_fluid, density_gas=density_gas, density_fluid=density_fluid,
    )
    _, m0g, m1g = stream_bounce_moments(D3Q19, g, flags)
    return rho, vel, density, m0g, m1g


def stream_macro_launch(f, g, flags, rho_old, vel_old, consts, ghosts=None):
    """Check shapes, allocate the 5 outputs and launch the stream-macro
    kernel (its bfloat16 instance for bfloat16 f and g, its slab form with
    ``ghosts``); shared with the capillogue's and the epilogue's emissions,
    which count their own launches."""
    B, Q, Z, Y, X = f.shape
    check_batch("lbm_prologue", B, ghosts is not None)
    check_cuda("f", f, STORAGE, (B, 19, Z, Y, X))
    check_cuda("g", g, (f.dtype,), (B, 19, Z, Y, X))
    check_cuda("flags", flags, torch.uint8, (B, 1, Z, Y, X))
    check_cuda("rho_old", rho_old, torch.float32, (B, 1, Z, Y, X))
    check_cuda("vel_old", vel_old, torch.float32, (B, 3, Z, Y, X))
    if ghosts is not None:
        for name, t in zip(("f_lo", "f_hi", "g_lo", "g_hi"), ghosts, strict=True):
            check_cuda(name, t, (f.dtype,), (1, 5, 1, Y, X))
    rho = torch.empty_like(rho_old)
    vel = torch.empty_like(vel_old)
    den = torch.empty_like(rho_old)
    m0g = torch.empty_like(rho_old)
    m1g = torch.empty_like(vel_old)
    call("lbm_prologue", ptr(f), ptr(g), ptr(flags), ptr(rho_old), ptr(vel_old), ptr(rho),
         ptr(vel), ptr(den), ptr(m0g), ptr(m1g), ctypes.c_int(B), ctypes.c_int(Z),
         ctypes.c_int(Y), ctypes.c_int(X), *(ctypes.c_double(float(v)) for v in consts),
         ctypes.c_int(f.dtype == torch.bfloat16),
         *(ptr(t) for t in (ghosts or (None,) * 4)), stream_of(f))
    return rho, vel, den, m0g, m1g


def lbm_prologue(f, g, flags, rho_old, vel_old, ghosts=None, *, c, rho_gas, rho_fluid,
                 density_gas, density_fluid):
    """f, g [B, 19, Z, Y, X] float32 or bfloat16, flags uint8, rho_old
    [B, 1, ...], vel_old [B, 3, ...] float32 -> (rho, vel, density, m0g,
    m1g) float32, the B elements in one launch; with ``ghosts`` the slab
    form (B = 1).  CPU tensors take the plain
    version; CUDA tensors launch the kernel on their card; anything else
    raises."""
    consts = dict(c=c, rho_gas=rho_gas, rho_fluid=rho_fluid, density_gas=density_gas,
                  density_fluid=density_fluid)
    if f.device.type == "cpu":
        return lbm_prologue_plain(f, g, flags, rho_old, vel_old, ghosts, **consts)
    check_no_grad("lbm_prologue", f, g, rho_old, vel_old)
    out = stream_macro_launch(f, g, flags, rho_old, vel_old, tuple(consts.values()), ghosts)
    count_launch(lbm_prologue, f.dtype == torch.bfloat16, "slab" if ghosts is not None else None,
                 f.shape[0])
    return out


lbm_prologue.launches = 0
lbm_prologue.launches_bf16 = 0
lbm_prologue.launches_slab = 0
lbm_prologue.launches_batch = 0


def cost_epilogue(f, g, flags, rho, vel, density, pressure, force, dfai, dprho, *,
                  emit_mac=False, mac_consts=None, **_) -> tuple[int, int]:
    """(bytes, flops) that a call on these inputs must move and do: f and g
    (in their storage type) read and written and flags read at every cell,
    the 15 macro channels only at fluid cells (other cells keep their
    bounced values), about 900 flops per fluid cell (B9's collide).
    ``emit_mac`` adds the prologue's count on f'/g' less its reads of f, g
    and flags: 9 channels written at every cell, rho and vel read at
    obstacles too."""
    n = flags.numel()
    n_fluid = int((flags == int(CellType.FLUID)).sum())
    fg = 19 * (elem_bytes(f) + elem_bytes(g))
    nbytes, flops = n * (2 * fg + 1) + 60 * n_fluid, 900 * n_fluid
    if emit_mac:
        pro_bytes, pro_flops = cost(f, g, flags, rho, vel)
        nbytes += pro_bytes - n * (fg + 1)
        flops += pro_flops
    return nbytes, flops


def cost_epilogue_slab(f, g, flags, rho, vel, density, pressure, force, dfai, dprho,
                       ghosts=None, emit_ghosts=None, *, emit_mac=False, mac_consts=None,
                       **_) -> tuple[int, int]:
    """:func:`cost_epilogue` of the slab form: the ghost planes' 5 channels
    of f and g a side read once more, and with ``emit_mac`` the collided
    ones the emission takes."""
    nbytes, flops = cost_epilogue(f, g, flags, rho, vel, density, pressure, force, dfai,
                                  dprho, emit_mac=emit_mac)
    gh = sum(t.numel() * t.element_size() for t in ghosts)
    return nbytes + gh * (2 if emit_mac else 1), flops


def lbm_epilogue_plain(f, g, flags, rho, vel, density, pressure, force, dfai, dprho,
                       ghosts=None, emit_ghosts=None, *, tau_f, tau_g, dx=1.0, dt=1.0,
                       emit_mac=False, mac_consts=None):
    """Plain PyTorch version of :func:`lbm_epilogue`.  The slab form streams
    f and g extended by their ghost planes (:func:`extend_ghosts`), keeps
    the slab's planes and emits through B4's plain slab form."""
    def post(x, i):
        if ghosts is None:
            return bounce_back(D3Q19, stream(D3Q19, x), flags)
        ext = extend_ghosts(x, ghosts[i], ghosts[i + 1])
        return bounce_back(D3Q19, stream(D3Q19, ext), repeat_ends(flags))[:, :, 1:-1]

    f_n, g_n = hcz_collide(
        D3Q19, post(f, 0), post(g, 2), rho, vel, density, pressure, flags,
        force, dfai, dprho, tau_f=tau_f, tau_g=tau_g, dx=dx, dt=dt,
    )
    if not emit_mac:
        return f_n, g_n
    c, rho_gas, rho_fluid, density_gas, density_fluid = mac_consts
    return f_n, g_n, lbm_prologue_plain(
        f_n, g_n, flags, rho, vel, None if ghosts is None else emit_ghosts(f_n, g_n), c=c,
        rho_gas=rho_gas, rho_fluid=rho_fluid, density_gas=density_gas,
        density_fluid=density_fluid,
    )


def lbm_epilogue(f, g, flags, rho, vel, density, pressure, force, dfai, dprho, ghosts=None,
                 emit_ghosts=None, *, tau_f, tau_g, dx=1.0, dt=1.0, emit_mac=False,
                 mac_consts=None):
    """Re-stream, bounce and HCZ-collide f and g [B, 19, Z, Y, X] float32
    or bfloat16 (f'/g' in the same type) with this step's float32 rho,
    density, pressure [B, 1, ...] and vel, force,
    dfai, dprho [B, 3, ...] (flags uint8) -> ``(f', g')``, the B elements
    in one launch (the plan's strip is an element's).  With
    ``emit_mac`` (and ``mac_consts = (c, rho_gas, rho_fluid, density_gas,
    density_fluid)``) -> ``(f', g', (rho, vel, density, m0g, m1g))``, the
    next step's macros: the prologue on f'/g' with rho_old = ``rho`` and
    vel_old = ``vel``.  ``ghosts`` (and ``emit_ghosts`` with ``emit_mac``)
    give the slab form (module docstring, B = 1).  CPU tensors take the plain
    version; CUDA tensors launch the kernel under ``plan`` (with
    ``emit_mac`` then the prologue's); anything else raises.  Inputs are
    not modified."""
    kw = dict(tau_f=tau_f, tau_g=tau_g, dx=dx, dt=dt, emit_mac=emit_mac,
              mac_consts=mac_consts)
    slab = ghosts is not None
    if slab and emit_mac and emit_ghosts is None:
        raise ValueError("lbm_epilogue: the slab form's emit_mac needs emit_ghosts")
    if f.device.type == "cpu":
        return lbm_epilogue_plain(f, g, flags, rho, vel, density, pressure, force, dfai,
                                  dprho, ghosts, emit_ghosts, **kw)
    check_no_grad("lbm_epilogue", f, g, rho, vel, density, pressure, force, dfai, dprho)
    B, Q, Z, Y, X = f.shape
    check_batch("lbm_epilogue", B, slab)
    check_cuda("f", f, STORAGE, (B, 19, Z, Y, X))
    check_cuda("g", g, (f.dtype,), (B, 19, Z, Y, X))
    for name, t in (("rho", rho), ("density", density), ("pressure", pressure)):
        check_cuda(name, t, torch.float32, (B, 1, Z, Y, X))
    for name, t in (("vel", vel), ("force", force), ("dfai", dfai), ("dprho", dprho)):
        check_cuda(name, t, torch.float32, (B, 3, Z, Y, X))
    check_cuda("flags", flags, torch.uint8, (B, 1, Z, Y, X))
    if min(Z, Y, X) < lbm_epilogue.min_axis or (emit_mac and mac_consts is None):
        raise ValueError(f"lbm_epilogue needs Z, Y, X >= {lbm_epilogue.min_axis}, and "
                         "mac_consts with emit_mac")
    if slab:
        for name, t in zip(("f_lo", "f_hi", "g_lo", "g_hi"), ghosts, strict=True):
            check_cuda(name, t, (f.dtype,), (1, 5, 1, Y, X))
    bf16 = f.dtype == torch.bfloat16
    pl = plan(Z, Y, X, torch.cuda.get_device_properties(f.device).multi_processor_count, bf16)
    f_out, g_out = torch.empty_like(f), torch.empty_like(g)
    args = (ptr(f), ptr(g), ptr(flags), ptr(rho), ptr(vel), ptr(density), ptr(pressure),
            ptr(force), ptr(dfai), ptr(dprho), ptr(f_out), ptr(g_out))
    dims = (ctypes.c_int(Z), ctypes.c_int(Y), ctypes.c_int(X))
    consts = (ctypes.c_double(dx), ctypes.c_double(dt), ctypes.c_double(tau_f),
              ctypes.c_double(tau_g), ctypes.c_int(bf16))
    if slab:
        if pl.form != "stage":
            raise ValueError(f"lbm_epilogue: the slab form is the stage form, not {pl.form}")
        call("lbm_epilogue_slab", *args, *dims, ctypes.c_int(pl.zb), *consts,
             *(ptr(t) for t in ghosts), stream_of(f))
    else:
        call("lbm_epilogue", *args, ctypes.c_int(B), *dims, ctypes.c_int(FORMS.index(pl.form)),
             ctypes.c_int(pl.zb), *consts, stream_of(f))
    form = "slab" if slab else None
    count_launch(lbm_epilogue, bf16, form, B)
    if not emit_mac:
        return f_out, g_out
    mac = stream_macro_launch(f_out, g_out, flags, rho, vel, mac_consts,
                              emit_ghosts(f_out, g_out) if slab else None)
    count_launch(lbm_epilogue, bf16, form, B)
    return f_out, g_out, mac


lbm_epilogue.launches = 0
lbm_epilogue.launches_bf16 = 0
lbm_epilogue.launches_slab = 0
lbm_epilogue.launches_batch = 0
#: cells an axis needs at least (the kernel's boundary ring)
lbm_epilogue.min_axis = 4
