"""The reference's driver API, op by op, on the card.

Port of ``lbm_ferrofluid_tpu/compat.py`` (:43-276), the facade over the
reference's runner (src/LBM/simulation/simulation_runner.py:22-195) and the
op classes it creates: the same ``SimulationParameters`` and
``SimulationRunner`` factories and the same method names and keyword
signatures (``propagation``, ``rebounce_obstacle``, ``macro_compute``,
``get_feq_``, ``collision``, ``capillary_process``, ``get_H_int``, ...),
with tensors in and out.

``device`` means what the reference meant: ``None`` is the card (raising
without CUDA, ``utils/device.py:resolve_device``) and ``"cpu"`` runs the
plain PyTorch ops.  The ops run on their tensors' device.  On the card,
3D float32 tensors launch the kernels that the JAX facade reaches on a
TPU: ``capillary_process`` the contact-angle rewrite (B2) and the
capillary stage's stencil route (B10b, then B10a over 3 fields, or 4 with
``H2``/``phi``; ``ops/kernels/stencil3d.py:hcz_capillary_stencils``), and
the HCZ ``collision`` without KBC the fused collide (B9).  2D, float64 and
KBC run the plain ops, as in the JAX facade; a grid the kernels cannot
take raises (``models/multiphase.py:check_kernel_grid``) instead of
running the plain ops on the card.  The kernels have no backward: under
autograd they raise (``ops/kernels/_lib.py:check_no_grad``), so gradients
go through ``device="cpu"``.

New code should use ``lbm_ferrofluid_tpu_torch.models``: its steps fuse
what the facade launches op by op.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .lattice import get_lattice
from .models.multiphase import check_kernel_grid
from .ops import (
    bgk_collide,
    bounce_back,
    contact_angle_boundary,
    eos_pressure,
    feq,
    geq,
    hcz_capillary,
    hcz_collide,
    kbc_collide,
    macro_moments,
    magnetic_sweep,
    rho_to_density,
    sc_collide,
    stream,
    vorticity_2d,
)
from .ops.kernels import PATHS, contact_angle_3d, hcz_capillary_stencils, hcz_collide_fused
from .utils.device import resolve_device
from .utils.types import KBCType

__all__ = ["SimulationParameters", "SimulationRunner"]


class SimulationParameters:
    """Drop-in analog of the reference's parameter object
    (simulation_parameters.py:6-83).  ``device`` None is the card and
    raises without CUDA; ``"cpu"`` runs the plain ops."""

    def __init__(
        self,
        dtype=torch.float32,
        dim: int = 2,
        dt: float = 1.0,
        device=None,
        simulation_size=(1, 1, 256, 256),
        density_gas: float = 0.0,
        density_fluid: float = 1.0,
        contact_angle: float = 0.75 * math.pi,
        Q: int = 9,
        tau: float = 1.0,
        rho_gas: float = 0.038,
        rho_fluid: float = 0.265,
        kappa: float = 0.08,
        tau_g: float = 0.7,
        tau_f: float = 0.7,
        k: float = 1.0,
    ):
        self.device = resolve_device(device)
        self.dim = dim
        self.dtype = dtype
        self.dt = dt
        self.frame = 0
        self.time_per_frame = 0.0
        self.frame_length = 1.0
        self.time_total = 0.0
        if dim == 2 and len(simulation_size) != 4:
            raise ValueError(
                "For 2d simulation simulation size should have 4 parameters"
                " B x C x H x W"
            )
        self.simulation_size = tuple(simulation_size)
        self.density_gas = density_gas
        self.density_fluid = density_fluid
        self.contact_angle = float(np.asarray(contact_angle).reshape(-1)[0])
        self.Q = Q
        self.tau = tau
        self.rho_gas = rho_gas
        self.rho_fluid = rho_fluid
        self.kappa = kappa
        self.tau_g = tau_g
        self.tau_f = tau_f
        self.k = k

    def step(self):
        self.time_per_frame += self.dt
        self.time_total += self.dt
        if self.time_per_frame >= self.frame_length:
            self.frame += 1
            self.time_total = self.frame * self.frame_length
            self.time_per_frame = 0.0

    def get_dx(self):
        return 1.0 / max(self.simulation_size)

    def is_2d(self):
        return self.dim == 2

    def is_3d(self):
        return self.dim == 3


def _on_kernels(t: torch.Tensor) -> bool:
    """Whether an op on ``t`` takes the kernel route: 3D float32 on the card."""
    return t.device.type == "cuda" and t.ndim == 5 and t.dtype == torch.float32


class _Propagation:
    def __init__(self, lat):
        self._lat = lat
        self.rank = lat.dim

    def propagation(self, f):
        return stream(self._lat, f)

    def rebounce_obstacle(self, f, flags):
        return bounce_back(self._lat, f, flags)


class _MacroCompute:
    def __init__(self, lat, p: SimulationParameters):
        self._lat = lat
        self._p = p

    def macro_compute(self, dx, dt, f, rho, vel, flags, g=None, pressure=None,
                      density=None):
        rho_new, vel_new = macro_moments(self._lat, f, rho, vel, flags, dx=dx, dt=dt)
        if density is not None:
            return [rho_new, vel_new, rho_to_density(rho_new, **_gas(self._p))]
        return [rho_new, vel_new]

    def get_pressure(self, dx, dt, density):
        return eos_pressure(density, dx=dx, dt=dt)

    def get_vort(self, vel, dx):
        return vorticity_2d(vel, dx)


def _gas(p: SimulationParameters) -> dict:
    return dict(rho_gas=p.rho_gas, rho_fluid=p.rho_fluid, density_gas=p.density_gas,
                density_fluid=p.density_fluid)


class _CollisionBase:
    def __init__(self, lat, p: SimulationParameters):
        self._lat = lat
        self._p = p
        self._gravity = np.zeros((1, lat.dim, *([1] * lat.dim)), np.float32)

    def set_gravity(self, gravity: float):
        g = np.zeros((1, self._lat.dim, *([1] * self._lat.dim)), np.float32)
        g[0, 1] = -gravity
        self._gravity = g

    def preset_KBC(self, dx, dt):  # moment tables are built on the fly
        return None

    def get_feq_(self, dx, dt, rho, vel, force=None):
        return feq(self._lat, rho, vel, dx=dx, dt=dt, tau=self._p.tau, force=force)

    def get_geq_(self, dx, dt, rho, density, vel, pressure, force=None, feq=None):
        return geq(self._lat, rho, density, pressure, feq, vel=vel, dx=dx, dt=dt,
                   tau=self._p.tau, force=force)

    def equation_of_states(self, dx, dt, rho):
        return eos_pressure(rho, dx=dx, dt=dt)


class _Collision(_CollisionBase):
    def collision(self, dx, dt, f, rho, vel, flags, force, KBC_type=None):
        # LBMCollision2d accepts and ignores KBC_type (LBM_collision_2d.py:267)
        return bgk_collide(self._lat, f, rho, vel, flags, force, tau=self._p.tau, dx=dx,
                           dt=dt)


class _CollisionMRT(_CollisionBase):
    def collision(self, dx, dt, f, rho, vel, flags, force, KBC_type=None):
        return kbc_collide(self._lat, f, rho, vel, flags, force, tau=self._p.tau,
                           kbc_type=KBC_type, dx=dx, dt=dt)


class _CollisionSC(_CollisionBase):
    def collision(self, dx, dt, f, rho, density, vel, flags, force, KBC_type=None):
        density_wall = 0.5 * (self._p.density_gas + self._p.density_fluid)
        f_new, _force = sc_collide(self._lat, f, rho, density, vel, flags, tau=self._p.tau,
                                   density_wall=density_wall, dx=dx, dt=dt)
        return f_new


class _CollisionHCZ(_CollisionBase):
    def capillary_process(self, rho, vel, flags, force, dt=1.0, dx=1.0, g=None,
                          density=None, pressure=None, H2=None, phi=None):
        """The contact-angle rewrite, then the capillary stage (the JAX
        ``hcz_capillary`` with ``g_sum=None``).  Returns [rho, vel,
        density, pressure, force, dfai, dprho]; on the card a 3D float32
        rho launches B2, B10b and B10a."""
        p = self._p
        kernels = _on_kernels(rho)
        if kernels:
            check_kernel_grid(rho, False, PATHS["compat3d"])
            rho_ca = contact_angle_3d(rho, flags, p.contact_angle)
        else:
            rho_ca = contact_angle_boundary(rho, flags, p.contact_angle)
        stage = hcz_capillary_stencils if kernels else hcz_capillary
        return list(stage(
            rho, vel, flags, density, pressure, rho_ca, H2, phi, g=g, kappa=p.kappa,
            gravity=torch.as_tensor(self._gravity, dtype=vel.dtype, device=vel.device),
            dx=dx, dt=dt, **_gas(p),
        ))

    def collision(self, dx, dt, f, rho, vel, density, flags, force, g=None,
                  pressure=None, dfai=None, dprho=None, KBC_type=None):
        """The HCZ collide of f and g -> [f', g']; on the card a 3D float32
        rho without KBC launches B9."""
        p = self._p
        if _on_kernels(rho) and not KBCType.is_KBC(KBC_type):
            check_kernel_grid(rho, False, PATHS["compat3d"])
            return list(hcz_collide_fused(f, g, rho, vel, density, pressure, flags, force,
                                          dfai, dprho, tau_f=p.tau_f, tau_g=p.tau_g, dx=dx,
                                          dt=dt))
        return list(hcz_collide(self._lat, f, g, rho, vel, density, pressure, flags, force,
                                dfai, dprho, tau_f=p.tau_f, tau_g=p.tau_g,
                                kbc_type=KBC_type, dx=dx, dt=dt))


class _Magnetic:
    def __init__(self, lat, p: SimulationParameters):
        self._lat = lat
        self._p = p

    def get_H_int(self, dt, dx, phi, flags, H_ext_mac, h):
        H_int, h_new = magnetic_sweep(self._lat, h, phi, flags, list(H_ext_mac),
                                      tau=self._p.tau, dx=dx, dt=dt)
        return [H_int, h_new]


class SimulationRunner:
    """Factory facade matching the reference runner
    (simulation_runner.py:22-195)."""

    def __init__(self, parameters: SimulationParameters):
        self.parameters = parameters
        self._lat = get_lattice(parameters.dim)

    def create_propagation(self):
        return _Propagation(self._lat)

    def create_macro_compute(self):
        return _MacroCompute(self._lat, self.parameters)

    def create_collision(self):
        return _Collision(self._lat, self.parameters)

    def create_collision_MRT(self):
        # the reference returns None for 3D (simulation_runner.py:107-108)
        if self.parameters.is_3d():
            return None
        return _CollisionMRT(self._lat, self.parameters)

    def create_collision_SC(self):
        if self.parameters.is_3d():
            return None
        return _CollisionSC(self._lat, self.parameters)

    def create_collision_HCZ(self):
        return _CollisionHCZ(self._lat, self.parameters)

    def create_LBM_magnetic(self):
        return _Magnetic(self._lat, self.parameters)

    def step(self):
        self.parameters.step()
