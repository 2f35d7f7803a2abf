"""Hand-written Hopper kernels of the port (counterpart of the JAX package's
``ops/pallas/``).

Each module holds a kernel's wrapper, its plain PyTorch version, its
``cost`` (the bytes and flops a call's inputs need) and its launch counters
(``wrapper.launches``, one per CUDA launch, and ``wrapper.launches_bf16``,
one per launch of the instance that takes bfloat16 f/g/h storage).  A
wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises.  The CUDA sources are
``lbm_ferrofluid_tpu_torch/csrc``; ``_lib`` builds them at first use.
"""

from __future__ import annotations

from types import ModuleType
from typing import Callable, NamedTuple

from . import (
    capillogue,
    capmac,
    contact3d,
    fused_step,
    hcz3d,
    poisson,
    scalar_poisson,
    stencil3d,
    stream3d,
)
from .capillogue import lbm_capillogue, lbm_capillogue_plain
from .capmac import hcz_capillary_gradmac, hcz_capillary_gradmac_plain
from .contact3d import contact_angle_3d, contact_angle_3d_plain
from .fused_step import lbm_epilogue, lbm_epilogue_plain, lbm_prologue, lbm_prologue_plain
from .hcz3d import hcz_collide_fused, hcz_collide_fused_plain
from .poisson import poisson_sweeps, poisson_sweeps_plain
from .scalar_poisson import scalar_wavefront, scalar_wavefront_plain
from .stencil3d import (
    capillary_stack,
    grad_fields,
    grad_fields_plain,
    hcz_capillary_stencils,
    laplacian_field,
    laplacian_field_plain,
)
from .stream3d import (
    stream_bounce_macro,
    stream_bounce_macro_plain,
    stream_bounce_moments,
    stream_bounce_moments_plain,
)

__all__ = [
    "Kernel",
    "KERNELS",
    "PATHS",
    "BF16_FORMS",
    "launch_counts",
    "reset_launch_counts",
    "scalar_wavefront",
    "scalar_wavefront_plain",
    "contact_angle_3d",
    "contact_angle_3d_plain",
    "lbm_capillogue",
    "lbm_capillogue_plain",
    "lbm_prologue",
    "lbm_prologue_plain",
    "lbm_epilogue",
    "lbm_epilogue_plain",
    "hcz_capillary_gradmac",
    "hcz_capillary_gradmac_plain",
    "stream_bounce_moments",
    "stream_bounce_moments_plain",
    "stream_bounce_macro",
    "stream_bounce_macro_plain",
    "hcz_collide_fused",
    "hcz_collide_fused_plain",
    "grad_fields",
    "grad_fields_plain",
    "laplacian_field",
    "laplacian_field_plain",
    "capillary_stack",
    "hcz_capillary_stencils",
    "poisson_sweeps",
    "poisson_sweeps_plain",
]


class Kernel(NamedTuple):
    """One ported TPU kernel: its module (which names ``CUDA_SOURCE``), its
    wrapper and plain version, its ``cost`` and the TPU kernel it
    replaces (file:line)."""

    module: ModuleType
    wrapper: Callable
    plain: Callable
    cost: Callable
    tpu_kernel: str


def _kernel(module, wrapper, plain, cost=None, tpu_kernel=None) -> Kernel:
    return Kernel(module, wrapper, plain, cost or module.cost,
                  tpu_kernel or module.TPU_KERNEL)


#: ROADMAP id -> every ported kernel
KERNELS = {
    "B1": _kernel(scalar_poisson, scalar_wavefront, scalar_wavefront_plain),
    "B2": _kernel(contact3d, contact_angle_3d, contact_angle_3d_plain),
    "B3": _kernel(capillogue, lbm_capillogue, lbm_capillogue_plain),
    "B4": _kernel(fused_step, lbm_prologue, lbm_prologue_plain),
    "B5": _kernel(fused_step, lbm_epilogue, lbm_epilogue_plain, fused_step.cost_epilogue,
                  fused_step.TPU_KERNEL_EPILOGUE),
    "B6": _kernel(capmac, hcz_capillary_gradmac, hcz_capillary_gradmac_plain),
    "B8a": _kernel(stream3d, stream_bounce_moments, stream_bounce_moments_plain,
                   stream3d.cost_moments, stream3d.TPU_KERNEL_MOMENTS),
    "B8b": _kernel(stream3d, stream_bounce_macro, stream_bounce_macro_plain,
                   stream3d.cost_macro, stream3d.TPU_KERNEL_MACRO),
    "B9": _kernel(hcz3d, hcz_collide_fused, hcz_collide_fused_plain),
    "B10a": _kernel(stencil3d, grad_fields, grad_fields_plain),
    "B10b": _kernel(stencil3d, laplacian_field, laplacian_field_plain,
                    stencil3d.cost_laplacian, stencil3d.TPU_KERNEL_LAPLACIAN),
    "B11b": _kernel(poisson, poisson_sweeps, poisson_sweeps_plain),
}

#: the kernels each path launches: the ferrofluid step (with its priming)
#: on the carried steady state with the scalar tau == 1 solve (B1) or the
#: channel-form solve (B11b + B10a); the un-carried step (an unprimed state,
#: here in channel form); the epilogue steady state (a 5-leaf premac, here
#: with the scalar carry); the HCZ step; the capillary stage's stencil route;
#: the reference-style 3D HCZ loop through ``compat.py``, op by op
PATHS = {
    "ferrofluid": ("B1", "B2", "B3", "B4"),
    "hcz": ("B2", "B6", "B8a", "B8b", "B9"),
    "ferrofluid_channel": ("B2", "B3", "B4", "B10a", "B11b"),
    "ferrofluid_uncarried": ("B4", "B11b", "B10a", "B2", "B6", "B5"),
    "ferrofluid_epilogue": ("B1", "B2", "B6", "B5"),
    "capillary_stencils": ("B10b", "B10a"),
    "singlephase3d": ("B8a",),
    "compat3d": ("B2", "B10b", "B10a", "B9"),
}


#: the kernels with a bfloat16-storage form (they read or write f, g or h)
BF16_FORMS = ("B3", "B4", "B5", "B8a", "B8b", "B9", "B11b")


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.wrapper.launches = 0
        k.wrapper.launches_bf16 = 0


def launch_counts(ids=None, bf16=False) -> dict[str, int]:
    """Launches per kernel id since the last reset (all ids, or ``ids``);
    with ``bf16`` only those of the bfloat16-storage forms."""
    attr = "launches_bf16" if bf16 else "launches"
    return {kid: getattr(KERNELS[kid].wrapper, attr, 0) for kid in (ids or KERNELS)}
