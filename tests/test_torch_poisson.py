"""The port's channel-form magnetic Poisson solve against the JAX package.

Inputs are made from a numpy seed and handed to both sides; the JAX Pallas
kernels run in interpret mode, as the JAX package's own tests run them on
the CPU (x64 is enabled by tests/conftest.py, so float32 inputs are cast
explicitly).  Bars, each with its reason:

* B11b plain against JAX ``poisson_sweeps`` in float32: rel <= 1e-6 — the
  same ``_sweep_math`` arithmetic in the same order; what remains is the
  compilers' FMA contraction.
* B11b plain (and the solve's tail) in float64 against the jnp body of
  ``solve_H_int``: rel <= 1e-12 — the body divides by (1 - w0) and collides
  as (1 - 1/tau) h + heq/tau + w rhs where ``_sweep_math`` multiplies by
  1/(1 - w0) and factors the weight out; float64 rounding of that
  refactoring only.
* B10a plain against JAX ``grad_fields``: rel <= 1e-6 in float32 — the
  kernel sums weighted taps and multiplies by 1/(12 dx), the port divides
  the reference's grouped sum by 12 dx.
* ``heq``, ``magnetic_sweep``, ``poisson_rhs_scaled`` and ``solve_H_int``:
  rel <= 1e-12 in float64 (the same formulas; reductions may associate
  differently), <= 1e-6 in float32.
* Slow: B11b plain against the TPU's other sweep kernels (B7 wavefront with
  each emission, B11a, B12): h' and psi at 1e-6 as above; H_int and H2,
  which those kernels compose in-kernel, against the port's tail at 2e-5
  (the bar of tests/test_pallas_poisson.py for the same composition).
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lbm_ferrofluid_tpu.lattice import D3Q19 as JD3Q19  # noqa: E402
from lbm_ferrofluid_tpu.ops import magnetic as jmagnetic  # noqa: E402
from lbm_ferrofluid_tpu.ops.equilibrium import heq as jheq  # noqa: E402
from lbm_ferrofluid_tpu.ops.pallas import poisson as jpoisson  # noqa: E402
from lbm_ferrofluid_tpu.ops.pallas.stencil3d import grad_fields as jgrad_fields  # noqa: E402
from lbm_ferrofluid_tpu.ops.stencils import staggered as jstaggered  # noqa: E402

from lbm_ferrofluid_tpu_torch.lattice import D3Q19  # noqa: E402
from lbm_ferrofluid_tpu_torch.ops import (  # noqa: E402
    heq,
    kernels,
    magnetic_sweep,
    poisson_rhs_scaled,
    solve_H_int,
)
from lbm_ferrofluid_tpu_torch.ops.magnetic import h_int_from_psi  # noqa: E402
from lbm_ferrofluid_tpu_torch.ops.stencils import staggered  # noqa: E402

OBS, FLUID = 2, 1
RES = (6, 8, 16)
H_EXT = (0.0, 85.0, 0.0)
DTYPES = {"float64": (np.float64, torch.float64, 1e-12),
          "float32": (np.float32, torch.float32, 1e-6)}


def rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def T(x):
    return torch.from_numpy(np.array(x))


def _mflags(res):
    """The Rosensweig magnetic shell (z planes, x-edge columns) plus an
    interior obstacle block."""
    Z, Y, X = res
    mf = np.full((1, 1, *res), OBS, np.uint8)
    mf[..., 1:-1, :, 1:-1] = FLUID
    mf[..., Z // 2 - 1:Z // 2 + 1, Y // 2 - 1:Y // 2 + 1, 5:7] = OBS
    return mf


def _inputs(res, seed, dtype=np.float32):
    """h, magnetic flags, rhs (float32-representable, in ``dtype``), phi and
    a non-uniform external field."""
    rng = np.random.default_rng(seed)
    mf = _mflags(res)
    h = rng.uniform(-0.1, 0.1, (1, 19, *res)).astype(np.float32)
    rhs = (rng.uniform(-1e-2, 1e-2, (1, 1, *res)) * (mf == FLUID)).astype(np.float32)
    phi = rng.uniform(-1.2, 1.2, (1, 1, *res)).astype(np.float32)
    H = (85.0 * (1.0 + 0.1 * rng.uniform(-1, 1, (1, 3, *res)))).astype(np.float32)
    return h.astype(dtype), mf, rhs.astype(dtype), phi.astype(dtype), H.astype(dtype)


# ---------------------------------------------------------------- B11b
@pytest.mark.parametrize("n_iters", [1, 4])
@pytest.mark.parametrize("tau", [1.0, 0.8])
def test_poisson_sweeps_plain_matches_jax_kernel(tau, n_iters):
    h, mf, rhs, _, _ = _inputs(RES, 1)
    jh, jpsi = jpoisson.poisson_sweeps(jnp.asarray(h), jnp.asarray(mf), jnp.asarray(rhs),
                                       tau=tau, n_iters=n_iters, interpret=True)
    ph, ppsi = kernels.poisson_sweeps_plain(T(h), T(mf), T(rhs), tau=tau, n_iters=n_iters)
    assert ph.dtype == ppsi.dtype == torch.float32
    assert rel(ph, jh) <= 1e-6
    assert rel(ppsi, jpsi) <= 1e-6
    # the wrapper on CPU tensors is the plain version and leaves h alone
    hk, psik = kernels.poisson_sweeps(T(h), T(mf), T(rhs), tau=tau, n_iters=n_iters)
    assert torch.equal(hk, ph) and torch.equal(psik, ppsi)


@pytest.mark.parametrize("tau", [1.0, 0.8])
def test_poisson_sweeps_plain_float64_matches_jnp_solve(tau):
    h, mf, rhs, _, _ = _inputs(RES, 2, np.float64)
    jH, jh = jmagnetic.solve_H_int(
        JD3Q19, jnp.asarray(h), None, jnp.asarray(mf), None, tau=tau, n_iters=4,
        use_pallas=False, rhs_scaled=jnp.asarray(rhs), h2_ext=H_EXT,
    )
    ph, psi = kernels.poisson_sweeps_plain(T(h), T(mf), T(rhs), tau=tau, n_iters=4)
    pH = h_int_from_psi(psi, T(mf), dx=1.0, h2_ext=H_EXT, grad=kernels.grad_fields)
    assert ph.dtype == torch.float64
    assert rel(ph, jh) <= 1e-12
    assert rel(pH, jH) <= 1e-12


# ---------------------------------------------------------------- B10a
@pytest.mark.parametrize("res", [RES, (3, 8, 16)])
@pytest.mark.parametrize("n_fields", [1, 4])
def test_grad_fields_plain_matches_jax_kernel(n_fields, res):
    x = np.random.default_rng(3).standard_normal((1, n_fields, *res)).astype(np.float32)
    want = jgrad_fields(jnp.asarray(x), dx=0.5, interpret=True)
    got = kernels.grad_fields_plain(T(x), dx=0.5)
    assert got.shape == (1, 3 * n_fields, *res)
    assert rel(got, want) <= 1e-6
    assert torch.equal(kernels.grad_fields(T(x), dx=0.5), got)


# ---------------------------------------------------------------- plain ops
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_heq_matches_jax(dtype):
    npt, _, bar = DTYPES[dtype]
    psi = np.random.default_rng(4).standard_normal((1, 1, *RES)).astype(npt)
    got = heq(D3Q19, T(psi))
    assert rel(got, jheq(JD3Q19, jnp.asarray(psi))) <= bar
    assert got.dtype == T(psi).dtype


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_poisson_rhs_staggered_matches_jax(dtype):
    npt, _, bar = DTYPES[dtype]
    _, mf, _, phi, H = _inputs(RES, 5, npt)
    want = jmagnetic.poisson_rhs_scaled(
        jnp.asarray(phi), jnp.asarray(mf), jstaggered(jnp.asarray(H)), None, tau=0.8,
        dx=1.0, dt=1.0, dim=3,
    )
    got = poisson_rhs_scaled(T(phi), T(mf), None, tau=0.8, dx=1.0, dt=1.0,
                             H_ext_mac=staggered(T(H)))
    assert rel(got, want) <= bar


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_magnetic_sweep_matches_jax(dtype):
    npt, _, bar = DTYPES[dtype]
    h, mf, _, phi, H = _inputs(RES, 6, npt)
    jH, jh = jmagnetic.magnetic_sweep(JD3Q19, jnp.asarray(h), jnp.asarray(phi),
                                      jnp.asarray(mf), jstaggered(jnp.asarray(H)), tau=0.8)
    pH, ph = magnetic_sweep(D3Q19, T(h), T(phi), T(mf), staggered(T(H)), tau=0.8)
    assert rel(ph, jh) <= bar
    assert rel(pH, jH) <= bar


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_solve_H_int_plain_matches_jax(dtype):
    npt, _, bar = DTYPES[dtype]
    h, mf, _, phi, H = _inputs(RES, 7, npt)
    jH, jh = jmagnetic.solve_H_int(
        JD3Q19, jnp.asarray(h), jnp.asarray(phi), jnp.asarray(mf), jstaggered(jnp.asarray(H)),
        tau=0.8, n_iters=4, use_pallas=False,
    )
    pH, ph = solve_H_int(D3Q19, T(h), T(phi), T(mf), staggered(T(H)), tau=0.8, n_iters=4)
    assert ph.dtype == T(h).dtype
    assert rel(ph, jh) <= bar
    assert rel(pH, jH) <= bar


# ---------------------------------------------------------------- slow
_VARIANTS = {
    "B7 psi": ("poisson_wavefront", {}),
    "B7 hint": ("poisson_wavefront", dict(emit="hint", dx=1.0)),
    "B7 h2": ("poisson_wavefront", dict(emit="h2", dx=1.0, h_ext=H_EXT)),
    "B11a": ("poisson_multisweep2", {}),
    "B12": ("poisson_multisweep", {}),
}


@pytest.mark.slow
@pytest.mark.parametrize("variant", sorted(_VARIANTS))
def test_poisson_sweeps_plain_matches_other_tpu_sweep_kernels(variant):
    """One kernel serves B7, B11a and B12: each computes B11b's sweeps."""
    res = (16, 8, 16)
    h, mf, rhs, _, _ = _inputs(res, 8)
    name, kw = _VARIANTS[variant]
    jh, jout = getattr(jpoisson, name)(jnp.asarray(h), jnp.asarray(mf), jnp.asarray(rhs),
                                       tau=0.8, n_iters=12, interpret=True, **kw)
    ph, psi = kernels.poisson_sweeps_plain(T(h), T(mf), T(rhs), tau=0.8, n_iters=12)
    assert rel(ph, jh) <= 1e-6
    if "emit" not in kw:
        assert rel(psi, jout) <= 1e-6
    else:
        tail = h_int_from_psi(psi, T(mf), dx=1.0, h2_ext=kw.get("h_ext"),
                              grad=kernels.grad_fields)
        assert tail.shape == tuple(jout.shape)
        assert rel(tail, jout) <= 2e-5
