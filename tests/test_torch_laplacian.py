"""B10b, the Laplacian, and the capillary stage's stencil route, against the
JAX package.

* B10b's plain version against ``isotropic_laplacian`` in float64 at
  rel <= 1e-12 (the same taps) and against the TPU kernel
  ``laplacian_field(interpret=True)`` in float32 at 1e-6 (the TPU kernel
  sums its taps in another order and multiplies by 1/(6 dx^2));
* ``hcz_capillary_stencils`` (B10b, substitution, B10a, force, recovery)
  against the JAX ``hcz_capillary(use_pallas=False)``, which runs the
  contact angle itself, with and without H2/phi, with the moments given and
  taken from g: 1e-10 in float64 (the same formulas, sums associated
  differently), 2e-5 in float32 (the bar of the step comparisons);
* on CPU tensors the route runs the plain versions and launches nothing.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lbm_ferrofluid_tpu.lattice import D3Q19 as JD3Q19  # noqa: E402
from lbm_ferrofluid_tpu.ops import collide as jcollide  # noqa: E402
from lbm_ferrofluid_tpu.ops.pallas.stencil3d import laplacian_field as jlaplacian  # noqa: E402
from lbm_ferrofluid_tpu.ops.stencils import isotropic_laplacian as jiso_lap  # noqa: E402

from lbm_ferrofluid_tpu_torch.ops import collide as pcollide  # noqa: E402
from lbm_ferrofluid_tpu_torch.ops import kernels  # noqa: E402

jstream = importlib.import_module("lbm_ferrofluid_tpu.ops.stream")

OBS, FLUID = 2, 1
RG, RF = 0.02381, 0.2508
GAS = dict(rho_gas=RG, rho_fluid=RF, density_gas=RG, density_fluid=RF)
ANGLE = 0.4 * np.pi
GRAV = (0.0, float(np.float32(-1e-5)), 0.0)


def rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def T(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------- B10b
@pytest.mark.parametrize("res", [(4, 5, 6), (6, 8, 10), (10, 12, 14)])
def test_laplacian_plain_matches_isotropic_laplacian(res):
    x = np.random.default_rng(1).standard_normal((1, 1, *res))
    want = jiso_lap(jnp.asarray(x), 0.5, 3)
    got = kernels.laplacian_field_plain(T(x), dx=0.5)
    assert got.dtype == torch.float64 and got.shape == (1, 1, *res)
    assert rel(got, want) <= 1e-12
    ring = np.ones(res, bool)
    ring[1:-1, 1:-1, 1:-1] = False
    assert not got[0, 0].numpy()[ring].any()


@pytest.mark.parametrize("res", [(4, 8, 16), (6, 8, 16)])
def test_laplacian_plain_matches_tpu_kernel(res):
    x = np.random.default_rng(2).standard_normal((1, 1, *res)).astype(np.float32)
    want = jlaplacian(jnp.asarray(x), dx=0.5, interpret=True)
    got = kernels.laplacian_field_plain(T(x), dx=0.5)
    assert got.dtype == torch.float32
    assert rel(got, want) <= 1e-6
    # the wrapper on CPU tensors is the plain version
    assert torch.equal(kernels.laplacian_field(T(x), dx=0.5), got)


# ---------------------------------------------------------------- stencil route
def _fields(res, seed, dtype):
    rng = np.random.default_rng(seed)
    Z, Y, X = res
    fl = np.full((1, 1, *res), OBS, np.uint8)
    fl[..., 1:-1, 1:-1, 1:-1] = FLUID
    fl[..., Z // 2, Y // 2, 2:4] = OBS
    w = JD3Q19.w_bcast(np.float64)
    d = dict(
        rho=RG + (RF - RG) * rng.uniform(0.0, 1.0, (1, 1, *res)),
        den=RG + (RF - RG) * rng.uniform(0.0, 1.0, (1, 1, *res)),
        pres=rng.uniform(0.01, 0.03, (1, 1, *res)),
        vel=rng.uniform(-0.02, 0.02, (1, 3, *res)),
        g=w * 0.02 * (1.0 + 0.1 * rng.standard_normal((1, 19, *res))),
        H2=1e4 * rng.uniform(0.9, 1.1, (1, 1, *res)),
        phi=rng.uniform(-1.2, 1.2, (1, 1, *res)),
        gsum=rng.uniform(0.01, 0.03, (1, 1, *res)),
        gmom=rng.uniform(-1e-3, 1e-3, (1, 3, *res)),
    )
    return dict({k: v.astype(dtype) for k, v in d.items()}, flags=fl)


@pytest.mark.parametrize("moments", ["from_g", "given"])
@pytest.mark.parametrize("kelvin", [False, True], ids=["no_kelvin", "kelvin"])
@pytest.mark.parametrize("dtype,bar", [(np.float64, 1e-10), (np.float32, 2e-5)],
                         ids=["float64", "float32"])
def test_stencil_route_matches_jax_capillary(dtype, bar, kelvin, moments):
    d = _fields((6, 8, 10), 3, dtype)
    J = {k: jnp.asarray(v) for k, v in d.items()}
    given = moments == "given"
    g_post = jstream.bounce_back(JD3Q19, jstream.stream(JD3Q19, J["g"]), J["flags"])
    want = jcollide.hcz_capillary(
        JD3Q19, J["rho"], J["vel"], J["flags"], g_post, J["den"], J["pres"],
        kappa=0.1, gravity=jnp.asarray(GRAV, dtype).reshape(1, 3, 1, 1, 1),
        contact_angle=ANGLE, dx=1.0, dt=1.0, H2=J["H2"] if kelvin else None,
        phi=J["phi"] if kelvin else None, g_sum=J["gsum"] if given else None,
        g_mom=J["gmom"] if given else None, use_pallas=False, **GAS,
    )
    rho_ca = kernels.contact_angle_3d_plain(T(d["rho"]), T(d["flags"]), ANGLE)
    got = kernels.hcz_capillary_stencils(
        T(d["rho"]), T(d["vel"]), T(d["flags"]), T(d["den"]), T(d["pres"]), rho_ca,
        T(d["H2"]) if kelvin else None, T(d["phi"]) if kelvin else None,
        T(d["gsum"]) if given else None, T(d["gmom"]) if given else None,
        g=T(np.asarray(g_post)), kappa=0.1,
        gravity=torch.tensor(GRAV, dtype=rho_ca.dtype).reshape(1, 3, 1, 1, 1), **GAS,
    )
    names = ("rho", "vel", "density", "pressure", "force", "dfai", "dprho")
    for name, a, b in zip(names, got, want, strict=True):
        assert a.dtype == rho_ca.dtype and rel(a, b) <= bar, f"{name}: {rel(a, b):.2e}"


def test_stencil_route_on_cpu_is_the_plain_stage():
    d = {k: T(v) for k, v in _fields((6, 8, 10), 4, np.float32).items()}
    kw = dict(kappa=0.1, gravity=torch.tensor(GRAV).reshape(1, 3, 1, 1, 1), **GAS)
    args = (d["rho"], d["vel"], d["flags"], d["den"], d["pres"], d["rho"], d["H2"], d["phi"],
            d["gsum"], d["gmom"])
    kernels.reset_launch_counts()
    got = kernels.hcz_capillary_stencils(*args, **kw)
    want = pcollide.hcz_capillary(*args, **kw)
    for a, b in zip(got, want, strict=True):
        assert a.is_contiguous() and rel(a, b) <= 1e-6
    assert kernels.launch_counts(["B10a", "B10b"]) == {"B10a": 0, "B10b": 0}
    with pytest.raises(ValueError, match="together"):
        kernels.hcz_capillary_stencils(*args[:7], None, *args[8:], **kw)


# ---------------------------------------------------------------- B10a's batch form
@pytest.mark.parametrize("n_fields", [1, 3])
@pytest.mark.parametrize("slab", [False, True], ids=["device", "slab"])
def test_grad_fields_batch_fold_layout(n_fields, slab):
    """B10a's batch form runs the B elements' N fields as the B * N fields of
    one element (a view of the contiguous [B, N, ...] input) and views its
    [1, 3BN, ...] output as [B, 3N, ...]: that fold gives every element the
    bits of its own call, in the plain version as in the kernel, which
    computes each field on its own.  The slab form folds its ghost planes
    alike."""
    B, res = 2, (6, 8, 10)
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (B, n_fields, *res)).astype(np.float32))
    args = (x[:, :, 1:-1].contiguous(), (x[:, :, :1].contiguous(), x[:, :, -1:].contiguous()),
            (1, 3)) if slab else (x,)

    def fold(t):
        return t.reshape(1, -1, *t.shape[2:])

    batched = kernels.grad_fields_plain(*args, dx=0.5)
    assert batched.shape == (B, 3 * n_fields, *args[0].shape[2:])
    folded = kernels.grad_fields_plain(
        fold(args[0]), *(((fold(args[1][0]), fold(args[1][1])), args[2]) if slab else ()),
        dx=0.5).reshape(batched.shape)
    assert torch.equal(folded, batched)
    for b in range(B):
        alone = kernels.grad_fields_plain(
            args[0][b:b + 1], *(((args[1][0][b:b + 1], args[1][1][b:b + 1]), args[2])
                                if slab else ()), dx=0.5)
        assert torch.equal(batched[b:b + 1], alone), b
    # the wrapper on CPU tensors is the plain version; a call of B elements
    # of N fields launches as B * N fields would, and costs B times one
    assert torch.equal(kernels.grad_fields(*args, dx=0.5), batched)
    assert kernels.stencil3d.launches_per_call(B * n_fields) == len(
        kernels.stencil3d.chunks(B * n_fields))
    c1, cb = kernels.stencil3d.cost(x[:1]), kernels.stencil3d.cost(x)
    assert cb == (B * c1[0], B * c1[1])
