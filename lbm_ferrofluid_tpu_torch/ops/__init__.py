"""Plain PyTorch operators of the main path and, under ``kernels``, the
hand-written CUDA kernels that replace the JAX package's Pallas kernels."""

from .collide import (
    CHI_K,
    MU0,
    bgk_collide,
    contact_angle_boundary,
    hcz_capillary,
    hcz_collide,
    kbc_collide,
    kbc_moment_split,
    sc_collide,
    sc_force,
    smooth_phi,
)
from .equilibrium import feq, gamma_quadratic, geq, heq
from .magnetic import magnetic_sweep, poisson_rhs_scaled, solve_H_int, solve_H_int_scalar
from .moments import eos_pressure, macro_moments, rho_to_density, vorticity_2d
from .stencils import (
    isotropic_grad,
    isotropic_laplacian,
    staggered,
    staggered_x,
    staggered_y,
    staggered_z,
)
from .stream import bounce_back, stream, stream_bounce_macro, stream_bounce_moments

__all__ = [
    "MU0",
    "CHI_K",
    "stream",
    "bounce_back",
    "stream_bounce_moments",
    "stream_bounce_macro",
    "feq",
    "geq",
    "gamma_quadratic",
    "heq",
    "macro_moments",
    "rho_to_density",
    "eos_pressure",
    "vorticity_2d",
    "isotropic_grad",
    "isotropic_laplacian",
    "staggered",
    "staggered_x",
    "staggered_y",
    "staggered_z",
    "bgk_collide",
    "kbc_moment_split",
    "kbc_collide",
    "sc_force",
    "sc_collide",
    "smooth_phi",
    "contact_angle_boundary",
    "hcz_capillary",
    "hcz_collide",
    "poisson_rhs_scaled",
    "magnetic_sweep",
    "solve_H_int",
    "solve_H_int_scalar",
]
