"""Hand-written Hopper kernels of the main path (counterpart of the JAX
package's ``ops/pallas/``).

Each module holds a kernel's wrapper, its plain PyTorch version and its
launch counter (``wrapper.launches``, one per CUDA launch).  A wrapper given
CPU tensors runs the plain version; given CUDA tensors it launches the
kernel or raises.  The CUDA sources are ``lbm_ferrofluid_tpu_torch/csrc``;
``_lib`` builds them at first use.
"""

from . import capillogue, contact3d, fused_step, scalar_poisson
from .capillogue import lbm_capillogue, lbm_capillogue_plain
from .contact3d import contact_angle_3d, contact_angle_3d_plain
from .fused_step import lbm_prologue, lbm_prologue_plain
from .scalar_poisson import scalar_wavefront, scalar_wavefront_plain

__all__ = [
    "KERNELS",
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
]

#: ROADMAP id -> (module, wrapper) of every kernel on the main path
KERNELS = {
    "B1": (scalar_poisson, scalar_wavefront),
    "B2": (contact3d, contact_angle_3d),
    "B3": (capillogue, lbm_capillogue),
    "B4": (fused_step, lbm_prologue),
}


def reset_launch_counts() -> None:
    for _, wrapper in KERNELS.values():
        wrapper.launches = 0


def launch_counts() -> dict[str, int]:
    return {kid: wrapper.launches for kid, (_, wrapper) in KERNELS.items()}
