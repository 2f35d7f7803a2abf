"""Plain PyTorch operators of the main path and, under ``kernels``, the
hand-written CUDA kernels that replace the JAX package's Pallas kernels."""

from .collide import (
    CHI_K,
    MU0,
    contact_angle_boundary,
    hcz_capillary,
    hcz_collide,
    smooth_phi,
)
from .equilibrium import feq, gamma_quadratic, geq
from .magnetic import poisson_rhs_scaled, solve_H_int_scalar
from .moments import eos_pressure, rho_to_density
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
    "rho_to_density",
    "eos_pressure",
    "isotropic_grad",
    "isotropic_laplacian",
    "staggered",
    "staggered_x",
    "staggered_y",
    "staggered_z",
    "smooth_phi",
    "contact_angle_boundary",
    "hcz_capillary",
    "hcz_collide",
    "poisson_rhs_scaled",
    "solve_H_int_scalar",
]
