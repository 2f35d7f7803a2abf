"""Order-parameter map and equation of state (PyTorch twins of
``lbm_ferrofluid_tpu/ops/moments.py``; reference:
LBM_macro_compute_2d.py:51-101)."""

from __future__ import annotations

__all__ = ["rho_to_density", "eos_pressure", "phi_from_density"]


def rho_to_density(rho, *, rho_gas, rho_fluid, density_gas, density_fluid):
    """Linear map from order parameter rho to physical density."""
    return density_gas + (density_fluid - density_gas) * (
        (rho - rho_gas) / (rho_fluid - rho_gas)
    )


def eos_pressure(density, *, dx=1.0, dt=1.0):
    """Carnahan-Starling equation of state with a=12RT, b=4:
    p = rho RT (4 br/4 - 2 (br/4)^2) / (1 - br/4)^3 + rho RT - a rho^2."""
    c = dx / dt
    RT = c * c / 3.0
    a = 12.0 * RT
    b = 4.0
    eta = b * density / 4.0
    om = 1.0 - eta
    return (
        density * RT * (4.0 * eta - 2.0 * eta * eta) / (om * om * om)
        + density * RT
        - a * density * density
    )


def phi_from_density(density, density_gas, density_fluid):
    """The order parameter phi = -(2 (density - rho_g)/(rho_l - rho_g) - 1)
    (demo_3d_LBM_Rosensweig_instability.py:171)."""
    return -(2.0 * (density - density_gas) / (density_fluid - density_gas) - 1.0)
