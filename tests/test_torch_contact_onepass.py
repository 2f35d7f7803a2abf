"""B2's one-pass rule, on the CPU.

The CUDA kernel (``csrc/contact3d.cu``) runs the contact-angle surgery as
one launch: each boundary cell evaluates its own stage's expression, with
every value an earlier stage wrote recomputed from rho and flags.
``onepass`` below is that closed-form rule, cell class by cell class, with
the kernel's operations in the kernel's order:

  x face          rho[s] + t hlp(rho at column 1 or X-2)
  y face          rho[s] + t hlp(rho at row 1 or Y-2, the x-face values
                  at (z, 1 or Y-2, x +- 1))
  z face          rho at plane 2 or Z-3
  z-edge line     (y face + x face) / 2
  plane-edge line (z face + the neighbour plane's x or y face) / 2
  corner          (three edge-line values) / 3

It must equal the sequential surgery ``contact_angle_boundary`` (the plain
version the kernel is held to on the card) bit for bit in float32, and the
JAX ``ops/collide.py:contact_angle_boundary`` at 1e-12 in float64.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lbm_ferrofluid_tpu.ops import collide as jcollide  # noqa: E402

from lbm_ferrofluid_tpu_torch.ops.collide import contact_angle_boundary  # noqa: E402
from lbm_ferrofluid_tpu_torch.ops.kernels import contact3d  # noqa: E402

OBS, FLUID = 2, 1
GRIDS = [(4, 4, 4), (4, 8, 16), (5, 7, 9), (16, 20, 24)]
#: 90 degrees is t = 0: the faces keep rho[s]
ANGLES = [0.75 * math.pi, 0.5 * math.pi, 0.35 * math.pi]


def onepass(rho, flags, angle):
    """The kernel's per-cell rule on [1, 1, Z, Y, X] tensors -> rho_ca."""
    R, F = rho[0, 0], flags[0, 0]
    Z, Y, X = R.shape
    t = math.tan(math.pi / 2.0 - angle)

    def other(i, n, a, b):
        """a where i == 0, b where i == n - 1."""
        return torch.where(i == 0, a, b)

    def face(s, p, m, q, w):
        return s + t * torch.sqrt(1e-6 + (p - m) * (p - m) + (q - w) * (q - w))

    def xface(z, y, x):
        xi, xs = other(x, X, 1, X - 2), other(x, X, 2, X - 3)
        val = face(R[z, y, xs], R[z + 1, y, xi], R[z - 1, y, xi], R[z, y + 1, xi],
                   R[z, y - 1, xi])
        return torch.where(F[z, y, x] == OBS, val, R[z, y, x])

    def after_x(z, y, x):
        return torch.where((x == 0) | (x == X - 1), xface(z, y, x), R[z, y, x])

    def yface(z, y, x):
        yi, ys = other(y, Y, 1, Y - 2), other(y, Y, 2, Y - 3)
        val = face(R[z, ys, x], R[z + 1, yi, x], R[z - 1, yi, x], after_x(z, yi, x + 1),
                   after_x(z, yi, x - 1))
        return torch.where(F[z, y, x] == OBS, val, R[z, y, x])

    def zface(z, y, x):
        return torch.where(F[z, y, x] == OBS, R[other(z, Z, 2, Z - 3), y, x], R[z, y, x])

    def z_edge(z, y, x):
        return 0.5 * (yface(z, y, other(x, X, 1, X - 2)) + xface(z, other(y, Y, 1, Y - 2), x))

    def x_border(z, y, x):  # plane 0 or Z-1, y interior
        return 0.5 * (zface(z, y, other(x, X, 1, X - 2)) + xface(other(z, Z, 1, Z - 2), y, x))

    def y_border(z, y, x):  # plane 0 or Z-1, x interior
        return 0.5 * (zface(z, other(y, Y, 1, Y - 2), x) + yface(other(z, Z, 1, Z - 2), y, x))

    def corner(z, y, x):
        zn, yn, xn = other(z, Z, 1, Z - 2), other(y, Y, 1, Y - 2), other(x, X, 1, X - 2)
        return (y_border(z, y, xn) + x_border(z, yn, x) + z_edge(zn, y, x)) / 3.0

    z, y, x = torch.meshgrid(torch.arange(Z), torch.arange(Y), torch.arange(X), indexing="ij")
    bz, by, bx = (z == 0) | (z == Z - 1), (y == 0) | (y == Y - 1), (x == 0) | (x == X - 1)
    classes = [
        (bx & ~by & ~bz, xface), (by & ~bx & ~bz, yface), (bz & ~bx & ~by, zface),
        (bx & by & ~bz, z_edge), (bz & bx & ~by, x_border), (bz & by & ~bx, y_border),
        (bz & by & bx, corner),
    ]
    out = R.clone()
    for mask, rule in classes:
        out[mask] = rule(z[mask], y[mask], x[mask])
    return out[None, None]


def seeded(res, seed, dtype):
    """rho in the scenes' range and random flags with obstacles on every
    face, edge line and corner."""
    rng = np.random.default_rng(seed)
    Z, Y, X = res
    rho = rng.uniform(0.02381, 0.2508, (1, 1, *res)).astype(dtype)
    fl = np.where(rng.uniform(size=(1, 1, *res)) < 0.5, OBS, FLUID).astype(np.uint8)
    fl[..., ::Z - 1, ::Y - 1, ::X - 1] = OBS  # corners
    for ax in range(3):  # an obstacle on each edge line and each face
        for lo in (0, -1):
            idx = [1, 1, 1]
            idx[ax] = lo
            fl[(0, 0, *idx)] = OBS
            for ax2 in range(3):
                if ax2 != ax:
                    for lo2 in (0, -1):
                        idx2 = list(idx)
                        idx2[ax2] = lo2
                        fl[(0, 0, *idx2)] = OBS
    return rho, fl


@pytest.mark.parametrize("angle", ANGLES)
@pytest.mark.parametrize("res", GRIDS)
def test_onepass_rule_equals_sequential_surgery_bit_for_bit(res, angle):
    rho, fl = seeded(res, sum(res), np.float32)
    rho, fl = torch.from_numpy(rho), torch.from_numpy(fl)
    want = contact_angle_boundary(rho, fl, angle)
    got = onepass(rho, fl, angle)
    assert torch.equal(got, want)
    # the surgery moved the boundary: the rule is not the identity here
    assert not torch.equal(want, rho) or angle == 0.5 * math.pi


@pytest.mark.parametrize("angle", ANGLES)
@pytest.mark.parametrize("res", GRIDS)
def test_onepass_rule_matches_jax_in_float64(res, angle):
    rho, fl = seeded(res, 7 + sum(res), np.float64)
    want = np.asarray(jcollide.contact_angle_boundary(jnp.asarray(rho), jnp.asarray(fl),
                                                      angle, 3))
    got = onepass(torch.from_numpy(rho), torch.from_numpy(fl), angle).numpy()
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


def test_wrapper_is_one_launch_and_needs_four_cells_an_axis():
    assert contact3d.N_LAUNCHES == 1
    assert contact3d.contact_angle_3d.min_axis == 4
    rho, fl = seeded((4, 4, 4), 3, np.float32)
    before = contact3d.contact_angle_3d.launches
    out = contact3d.contact_angle_3d(torch.from_numpy(rho), torch.from_numpy(fl), 0.75 * math.pi)
    assert contact3d.contact_angle_3d.launches == before  # the CPU takes the plain version
    assert torch.equal(out, onepass(torch.from_numpy(rho), torch.from_numpy(fl), 0.75 * math.pi))
