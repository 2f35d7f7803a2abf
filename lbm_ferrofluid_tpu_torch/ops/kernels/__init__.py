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
    psi_halo,
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
from .psi_halo import psi_ghost_band, psi_ghost_band_plain
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
    "GLUE_KERNELS",
    "PATHS",
    "BF16_FORMS",
    "SLAB_FORMS",
    "BATCH_FORMS",
    "SLAB_TPU_KERNELS",
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
    "psi_ghost_band",
    "psi_ghost_band_plain",
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

#: hand-written kernels of the port that replace jnp glue of the JAX
#: package, not a Pallas kernel (their ``tpu_kernel`` names the glue): the
#: psi-refreshed ghost bands of the meshed channel-form solve at tau == 1
#: (ROADMAP B-8), launched twice a round after the first where
#: ``parallel/step3d.py:poisson_sweeps_sharded`` takes them
GLUE_KERNELS = {
    "psi_band": _kernel(psi_halo, psi_ghost_band, psi_ghost_band_plain),
}

#: the kernels each path launches: the ferrofluid step (with its priming)
#: on the carried steady state with the scalar tau == 1 solve (B1) or the
#: channel-form solve (B11b, its last pass B7's trailing stage); the
#: un-carried step (an unprimed state, here in channel form); the epilogue
#: steady state (a 5-leaf premac, here
#: with the scalar carry); the HCZ step; the capillary stage's stencil route;
#: the reference-style 3D HCZ loop through ``compat.py``, op by op; the
#: padded transposed layout (``scenes.rosensweig_3d_tpu``) carried (B1's psi
#: form and its H2 launch on the box, B2 on the box, B3's box form) and
#: un-carried (B4, B1 as carried, B2 on the box, B5)
PATHS = {
    "ferrofluid": ("B1", "B2", "B3", "B4"),
    "hcz": ("B2", "B6", "B8a", "B8b", "B9"),
    "ferrofluid_channel": ("B2", "B3", "B4", "B11b"),
    "ferrofluid_uncarried": ("B4", "B11b", "B2", "B6", "B5"),
    "ferrofluid_epilogue": ("B1", "B2", "B6", "B5"),
    "capillary_stencils": ("B10b", "B10a"),
    "singlephase3d": ("B8a",),
    "compat3d": ("B2", "B10b", "B10a", "B9"),
    "ferrofluid_padded": ("B1", "B2", "B3", "B4"),
    "ferrofluid_padded_uncarried": ("B4", "B1", "B2", "B5"),
}

#: the kernels with a batch form: one launch steps every element of a
#: [B, ...] batch (``launches_batch`` counts the launches at B > 1; B10a
#: one a chunk of the elements' fields).  The routes a batch takes launch
#: only these: on one device the un-carried ferrofluid step on the
#: 19-channel h (B4, B11b with B7's trailing stage, B2, B6, B5), the HCZ
#: step (B8b, B8a, B2, B6, B9) and 3D single phase (B8a); on the block
#: route of a split grid the same, the ferrofluid solve on the psi route
#: (B11b's psi, then B10a); B1, B3 and B10b raise on a batch (ROADMAP A12
#: slice 8)
BATCH_FORMS = ("B2", "B4", "B5", "B6", "B8a", "B8b", "B9", "B10a", "B11b")

#: the kernels with a named form and its name (``launches_<name>`` counts
#: the launches of that form): B1's psi emission, B3's box form, B11b's
#: last pass with B7's trailing stage (``emit="hint"`` or ``"h2"``)
FORMS = {"B1": "psi", "B3": "box", "B11b": "emit"}


#: the kernels with a bfloat16-storage form (they read or write f, g or h)
BF16_FORMS = ("B3", "B4", "B5", "B8a", "B8b", "B9", "B11b")

#: the kernels with a slab form (``ghosts=``: a z-slab of a domain
#: decomposed along z over ranks, ``parallel/step3d.py``), whose launches
#: ``launches_slab`` counts: the z-slab paths of the capillogue steady
#: state (the solve, B2, B3, B4 at priming), and of the epilogue steady
#: state, the out-of-plane field and the un-carried step (the solve, B2,
#: B10b, B6, B5, B4), the solve B1 on the scalar carry or B11b and B10a
#: on a 19-channel h; the HCZ step (B8b, B8a, B2, B10b, B6; B9 is local)
SLAB_FORMS = ("B1", "B2", "B3", "B4", "B5", "B6", "B8a", "B8b", "B10a", "B10b", "B11b")

#: the TPU kernels' ghost modes that the slab forms replace (B11b's slab
#: form is the counterpart of B7's ghost-ref mode, the TPU's only channel-
#: form kernel with ghosts)
SLAB_TPU_KERNELS = {
    "B1": "lbm_ferrofluid_tpu/ops/pallas/scalar_poisson.py:562",
    "B2": "lbm_ferrofluid_tpu/ops/pallas/contact3d.py:309",
    "B3": "lbm_ferrofluid_tpu/ops/pallas/capillogue.py:809",
    "B4": "lbm_ferrofluid_tpu/ops/pallas/fused_step.py:721",
    "B5": "lbm_ferrofluid_tpu/ops/pallas/fused_step.py:779",
    "B6": "lbm_ferrofluid_tpu/ops/pallas/capmac.py:383",
    "B8a": "lbm_ferrofluid_tpu/ops/pallas/stream3d.py:164",
    "B8b": "lbm_ferrofluid_tpu/ops/pallas/stream3d.py:231",
    "B10a": "lbm_ferrofluid_tpu/ops/pallas/stencil3d.py:176",
    "B10b": "lbm_ferrofluid_tpu/ops/pallas/stencil3d.py:242",
    "B11b": "lbm_ferrofluid_tpu/ops/pallas/poisson.py:1301 (poisson_wavefront, B7, in its "
            "ghost-ref mode: ghosts=, emit_bands=)",
}


def reset_launch_counts() -> None:
    for k in GLUE_KERNELS.values():
        k.wrapper.launches = 0
        k.wrapper.launches_bf16 = 0
    for kid, k in KERNELS.items():
        k.wrapper.launches = 0
        k.wrapper.launches_bf16 = 0
        if kid in FORMS:
            setattr(k.wrapper, f"launches_{FORMS[kid]}", 0)
        if kid in SLAB_FORMS:
            k.wrapper.launches_slab = 0
        if kid in BATCH_FORMS:
            k.wrapper.launches_batch = 0


def launch_counts(ids=None, bf16=False, form=False, slab=False,
                  batch=False) -> dict[str, int]:
    """Launches per kernel id since the last reset (all ids, or ``ids``);
    with ``bf16`` only those of the bfloat16-storage forms, with ``form``
    only those of each kernel's named form (``FORMS``; 0 for the others),
    with ``slab`` only those of the slab forms (``SLAB_FORMS``; 0 for the
    others), with ``batch`` only those at a batch of more than one element
    (``BATCH_FORMS``; 0 for the others)."""
    def attr(kid):
        if batch:
            return "launches_batch"
        if slab:
            return "launches_slab"
        if form:
            return f"launches_{FORMS.get(kid)}"
        return "launches_bf16" if bf16 else "launches"
    return {kid: getattr(KERNELS[kid].wrapper, attr(kid), 0) for kid in (ids or KERNELS)}
