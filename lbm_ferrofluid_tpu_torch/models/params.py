"""Simulation parameters: one frozen, hashable, JSON-serializable dataclass.

Copy of ``lbm_ferrofluid_tpu/models/params.py`` with the same fields, the
same defaults and the same JSON, so one parameter file loads in both
packages (the port imports nothing of the JAX package).  Fields that select
JAX-only machinery (``use_pallas``, ``poisson_halo_depth``,
``poisson_psi_halo``, ``scalar_sliver``) are carried for that round trip and
read by nothing in the port; configurations the port does not cover yet
raise ``NotImplementedError`` at the step (``models/ferrofluid.py``).
"""

from __future__ import annotations

import dataclasses
import json
import math

import numpy as np

from ..lattice import Lattice, get_lattice

__all__ = ["SimulationParams"]


@dataclasses.dataclass(frozen=True)
class SimulationParams:
    """Physics + numerics configuration (all static)."""

    dim: int = 2
    dx: float = 1.0
    dt: float = 1.0

    # relaxation times
    tau: float = 1.0  # single-phase BGK/KBC and the magnetic Poisson solve
    tau_f: float = 0.7  # HCZ order-parameter distribution
    tau_g: float = 0.7  # HCZ pressure distribution

    # multiphase densities: physical (density_*) and order parameter (rho_*)
    density_gas: float = 0.038
    density_fluid: float = 0.265
    rho_gas: float = 0.038
    rho_fluid: float = 0.265

    kappa: float = 0.08  # surface tension coefficient
    contact_angle: float = 0.5 * math.pi
    gravity: float = 0.0  # magnitude; acts along -gravity_axis
    k: float = 0.33  # magnetic susceptibility scale

    kbc_type: int | None = None  # None/LBGK or a KBCType value
    # axis gravity acts along (negative direction; channel order x=0, y=1,
    # z=2); the reference hard-codes -y (LBM_collision_3d.py:124-131)
    gravity_axis: int = 1
    mag_strength: float = 0.0
    # axis of the constant external field H_ext = mag_strength * e_axis
    h_ext_axis: int = 1
    poisson_iters: int = 30
    poisson_halo_depth: int = 5
    # True promises the magnetic obstacle set lies in the x-edge columns
    # plus the two z-edge planes (the standard ferrofluid scene pattern)
    mag_flags_shell: bool = False
    poisson_psi_halo: bool = True
    # False keeps the magnetic solve in channel form (not ported: B7/B11)
    scalar_carry: bool = True
    scalar_sliver: bool = False
    use_pallas: bool = True
    # physical extent of an OBSTACLE-padded layout (not ported: A8)
    phys_extent: tuple[int, ...] | None = None
    # storage dtypes of h and of f/g (only "float32" is ported; A6)
    h_dtype: str = "float32"
    fg_dtype: str = "float32"

    @property
    def lattice(self) -> Lattice:
        return get_lattice(self.dim)

    @property
    def Q(self) -> int:
        return self.lattice.q

    @property
    def c(self) -> float:
        return self.dx / self.dt

    @property
    def cs2(self) -> float:
        return self.c * self.c / 3.0

    def gravity_vec(self, dtype=np.float32) -> np.ndarray:
        """Gravity vector [1, dim, 1...] acting along -gravity_axis
        (reference: -y, LBM_collision_2d.py:104-111 / _3d.py:124-131)."""
        g = np.zeros((1, self.dim, *([1] * self.dim)), dtype=dtype)
        g[0, self.gravity_axis] = -self.gravity
        return g

    @staticmethod
    def tau_from_reynolds(
        re: float, vmax: float, lmax: float, dx: float = 1.0, dt: float = 1.0
    ) -> float:
        """tau = 0.5 + nu/cs2 with nu = Vmax * Lmax / Re (demo_2d_LBM.py:32-36)."""
        c = dx / dt
        cs2 = c * c / 3.0
        return 0.5 + (vmax * lmax / re) / cs2

    # ------------------------------------------------------------------
    # JSON round trip (same format as the JAX package's)
    # ------------------------------------------------------------------
    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, s: str) -> "SimulationParams":
        d = json.loads(s)
        if d.get("phys_extent") is not None:
            d["phys_extent"] = tuple(d["phys_extent"])  # hashability
        return cls(**d)

    def replace(self, **kw) -> "SimulationParams":
        return dataclasses.replace(self, **kw)
