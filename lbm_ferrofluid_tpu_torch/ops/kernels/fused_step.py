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
from ._lib import (STORAGE, call, check_cuda, check_no_grad, count_launch, elem_bytes, ptr,
                   stream_of)

__all__ = [
    "lbm_prologue", "lbm_prologue_plain", "cost", "stream_macro_launch",
    "lbm_epilogue", "lbm_epilogue_plain", "cost_epilogue", "plan", "EpiloguePlan", "CELL",
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


def lbm_prologue_plain(f, g, flags, rho_old, vel_old, *, c, rho_gas, rho_fluid,
                       density_gas, density_fluid):
    """Plain PyTorch version of :func:`lbm_prologue`."""
    _, rho, vel, density = stream_bounce_macro(
        D3Q19, f, flags, rho_old, vel_old, c=c, rho_gas=rho_gas,
        rho_fluid=rho_fluid, density_gas=density_gas, density_fluid=density_fluid,
    )
    _, m0g, m1g = stream_bounce_moments(D3Q19, g, flags)
    return rho, vel, density, m0g, m1g


def stream_macro_launch(f, g, flags, rho_old, vel_old, consts):
    """Check shapes, allocate the 5 outputs and launch the stream-macro
    kernel (its bfloat16 instance for bfloat16 f and g); shared with the
    capillogue's and the epilogue's emissions, which count their own
    launches."""
    B, Q, Z, Y, X = f.shape
    check_cuda("f", f, STORAGE, (1, 19, Z, Y, X))
    check_cuda("g", g, (f.dtype,), (1, 19, Z, Y, X))
    check_cuda("flags", flags, torch.uint8, (1, 1, Z, Y, X))
    check_cuda("rho_old", rho_old, torch.float32, (1, 1, Z, Y, X))
    check_cuda("vel_old", vel_old, torch.float32, (1, 3, Z, Y, X))
    rho = torch.empty_like(rho_old)
    vel = torch.empty_like(vel_old)
    den = torch.empty_like(rho_old)
    m0g = torch.empty_like(rho_old)
    m1g = torch.empty_like(vel_old)
    call("lbm_prologue", ptr(f), ptr(g), ptr(flags), ptr(rho_old), ptr(vel_old), ptr(rho),
         ptr(vel), ptr(den), ptr(m0g), ptr(m1g), ctypes.c_int(Z), ctypes.c_int(Y),
         ctypes.c_int(X), *(ctypes.c_double(float(v)) for v in consts),
         ctypes.c_int(f.dtype == torch.bfloat16), stream_of(f))
    return rho, vel, den, m0g, m1g


def lbm_prologue(f, g, flags, rho_old, vel_old, *, c, rho_gas, rho_fluid,
                 density_gas, density_fluid):
    """f, g [1, 19, Z, Y, X] float32 or bfloat16, flags uint8, rho_old
    [1, 1, ...], vel_old [1, 3, ...] float32 -> (rho, vel, density, m0g,
    m1g) float32.  CPU tensors take the plain version; CUDA tensors launch
    the kernel; anything else raises."""
    if f.device.type == "cpu":
        return lbm_prologue_plain(
            f, g, flags, rho_old, vel_old, c=c, rho_gas=rho_gas, rho_fluid=rho_fluid,
            density_gas=density_gas, density_fluid=density_fluid,
        )
    check_no_grad("lbm_prologue", f, g, rho_old, vel_old)
    out = stream_macro_launch(
        f, g, flags, rho_old, vel_old, (c, rho_gas, rho_fluid, density_gas, density_fluid),
    )
    count_launch(lbm_prologue, f.dtype == torch.bfloat16)
    return out


lbm_prologue.launches = 0
lbm_prologue.launches_bf16 = 0


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


def lbm_epilogue_plain(f, g, flags, rho, vel, density, pressure, force, dfai, dprho, *,
                       tau_f, tau_g, dx=1.0, dt=1.0, emit_mac=False, mac_consts=None):
    """Plain PyTorch version of :func:`lbm_epilogue`."""
    f_n, g_n = hcz_collide(
        D3Q19, bounce_back(D3Q19, stream(D3Q19, f), flags),
        bounce_back(D3Q19, stream(D3Q19, g), flags), rho, vel, density, pressure, flags,
        force, dfai, dprho, tau_f=tau_f, tau_g=tau_g, dx=dx, dt=dt,
    )
    if not emit_mac:
        return f_n, g_n
    c, rho_gas, rho_fluid, density_gas, density_fluid = mac_consts
    return f_n, g_n, lbm_prologue_plain(
        f_n, g_n, flags, rho, vel, c=c, rho_gas=rho_gas, rho_fluid=rho_fluid,
        density_gas=density_gas, density_fluid=density_fluid,
    )


def lbm_epilogue(f, g, flags, rho, vel, density, pressure, force, dfai, dprho, *, tau_f,
                 tau_g, dx=1.0, dt=1.0, emit_mac=False, mac_consts=None):
    """Re-stream, bounce and HCZ-collide f and g [1, 19, Z, Y, X] float32
    or bfloat16 (f'/g' in the same type) with this step's float32 rho,
    density, pressure [1, 1, ...] and vel, force,
    dfai, dprho [1, 3, ...] (flags uint8) -> ``(f', g')``.  With
    ``emit_mac`` (and ``mac_consts = (c, rho_gas, rho_fluid, density_gas,
    density_fluid)``) -> ``(f', g', (rho, vel, density, m0g, m1g))``, the
    next step's macros: the prologue on f'/g' with rho_old = ``rho`` and
    vel_old = ``vel``.  CPU tensors take the plain version; CUDA tensors
    launch the kernel under ``plan`` (with ``emit_mac`` then the
    prologue's); anything else raises.  Inputs are not modified."""
    kw = dict(tau_f=tau_f, tau_g=tau_g, dx=dx, dt=dt, emit_mac=emit_mac,
              mac_consts=mac_consts)
    if f.device.type == "cpu":
        return lbm_epilogue_plain(f, g, flags, rho, vel, density, pressure, force, dfai,
                                  dprho, **kw)
    check_no_grad("lbm_epilogue", f, g, rho, vel, density, pressure, force, dfai, dprho)
    B, Q, Z, Y, X = f.shape
    check_cuda("f", f, STORAGE, (1, 19, Z, Y, X))
    check_cuda("g", g, (f.dtype,), (1, 19, Z, Y, X))
    for name, t in (("rho", rho), ("density", density), ("pressure", pressure)):
        check_cuda(name, t, torch.float32, (1, 1, Z, Y, X))
    for name, t in (("vel", vel), ("force", force), ("dfai", dfai), ("dprho", dprho)):
        check_cuda(name, t, torch.float32, (1, 3, Z, Y, X))
    check_cuda("flags", flags, torch.uint8, (1, 1, Z, Y, X))
    if min(Z, Y, X) < lbm_epilogue.min_axis or (emit_mac and mac_consts is None):
        raise ValueError(f"lbm_epilogue needs Z, Y, X >= {lbm_epilogue.min_axis}, and "
                         "mac_consts with emit_mac")
    bf16 = f.dtype == torch.bfloat16
    pl = plan(Z, Y, X, torch.cuda.get_device_properties(f.device).multi_processor_count, bf16)
    f_out, g_out = torch.empty_like(f), torch.empty_like(g)
    call("lbm_epilogue", ptr(f), ptr(g), ptr(flags), ptr(rho), ptr(vel), ptr(density),
         ptr(pressure), ptr(force), ptr(dfai), ptr(dprho), ptr(f_out), ptr(g_out),
         ctypes.c_int(Z), ctypes.c_int(Y), ctypes.c_int(X), ctypes.c_int(FORMS.index(pl.form)),
         ctypes.c_int(pl.zb), ctypes.c_double(dx), ctypes.c_double(dt), ctypes.c_double(tau_f),
         ctypes.c_double(tau_g), ctypes.c_int(bf16), stream_of(f))
    count_launch(lbm_epilogue, bf16)
    if not emit_mac:
        return f_out, g_out
    mac = stream_macro_launch(f_out, g_out, flags, rho, vel, mac_consts)
    count_launch(lbm_epilogue, bf16)
    return f_out, g_out, mac


lbm_epilogue.launches = 0
lbm_epilogue.launches_bf16 = 0
#: cells an axis needs at least (the kernel's boundary ring)
lbm_epilogue.min_axis = 4
