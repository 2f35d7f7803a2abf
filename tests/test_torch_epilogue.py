"""B5, the epilogue: its plain PyTorch version against the JAX package.

* in float64 against the JAX composition the un-fused step runs
  (``stream`` + ``bounce_back`` + ``hcz_collide``, ``use_pallas=False``, and
  for the emission ``stream_bounce_macro`` + ``stream_bounce_moments`` on
  f'/g') at rel <= 1e-12: the same taps in the same order;
* the emission is exactly :func:`lbm_prologue_plain` on f'/g' (the TPU
  kernel's emission is bit-identical to a prologue, tests/test_fused_step.py);
* the wrapper on CPU tensors is the plain version, leaves its inputs alone
  and launches nothing;
* slow: against the TPU kernel ``lbm_epilogue(interpret=True)`` in float32
  at tests/test_fused_step.py's bars (rtol 1e-4, atol 5e-7: FMA contraction
  around the re-stream, amplified by the geq cancellation in g).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lbm_ferrofluid_tpu.lattice import D3Q19 as JD3Q19  # noqa: E402
from lbm_ferrofluid_tpu.ops import collide as jcollide  # noqa: E402

from lbm_ferrofluid_tpu_torch.ops import kernels  # noqa: E402

# ops/__init__ re-exports the function ``stream`` over the module's name
jstream = importlib.import_module("lbm_ferrofluid_tpu.ops.stream")

OBS, FLUID = 2, 1
RG, RF = 0.02381, 0.2508
GAS = dict(rho_gas=RG, rho_fluid=RF, density_gas=RG, density_fluid=RF)
MAC_CONSTS = (1.0, RG, RF, RG, RF)
NAMES = ("f", "g", "rho", "vel", "den", "pres", "force", "dfai", "dprho")
RES = [(6, 8, 10), (10, 12, 14)]


def rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def T(x):
    return torch.from_numpy(np.array(x))


def _fields(res, seed):
    """Seeded float64 fields: an obstacle frame plus an interior obstacle
    block, near-equilibrium f and g, and a capillary stage's outputs."""
    rng = np.random.default_rng(seed)
    Z, Y, X = res
    fl = np.full((1, 1, *res), OBS, np.uint8)
    fl[..., 1:-1, 1:-1, 1:-1] = FLUID
    fl[..., Z // 2, Y // 2, 2:4] = OBS
    rho = RG + (RF - RG) * rng.uniform(0.0, 1.0, (1, 1, *res))
    w = JD3Q19.w_bcast(np.float64)
    return dict(
        flags=fl, rho=rho,
        f=w * rho * (1.0 + 0.1 * rng.standard_normal((1, 19, *res))),
        g=w * 0.02 * (1.0 + 0.1 * rng.standard_normal((1, 19, *res))),
        den=RG + (RF - RG) * rng.uniform(0.0, 1.0, (1, 1, *res)),
        pres=rng.uniform(0.01, 0.03, (1, 1, *res)),
        vel=rng.uniform(-0.02, 0.02, (1, 3, *res)),
        force=rng.uniform(-1e-4, 1e-4, (1, 3, *res)),
        dfai=rng.uniform(-1e-3, 1e-3, (1, 3, *res)),
        dprho=rng.uniform(-1e-3, 1e-3, (1, 3, *res)),
    )


def _args(d, conv):
    """(f, g, flags, rho, vel, density, pressure, force, dfai, dprho)."""
    return (conv(d["f"]), conv(d["g"]), conv(d["flags"]), conv(d["rho"]), conv(d["vel"]),
            conv(d["den"]), conv(d["pres"]), conv(d["force"]), conv(d["dfai"]),
            conv(d["dprho"]))


@pytest.mark.parametrize("emit_mac", [False, True], ids=["plain", "emit_mac"])
@pytest.mark.parametrize("res", RES)
def test_epilogue_plain_matches_jax_composition(res, emit_mac):
    d = _fields(res, 1)
    f, g, flags, rho, vel, den, pres, force, dfai, dprho = _args(d, jnp.asarray)
    f_post = jstream.bounce_back(JD3Q19, jstream.stream(JD3Q19, f), flags)
    g_post = jstream.bounce_back(JD3Q19, jstream.stream(JD3Q19, g), flags)
    f_n, g_n = jcollide.hcz_collide(
        JD3Q19, f_post, g_post, rho, vel, den, pres, flags, force, dfai, dprho,
        tau_f=0.68, tau_g=0.7, use_pallas=False,
    )
    want = [f_n, g_n]
    if emit_mac:
        _, rho_n, vel_n, den_n = jstream.stream_bounce_macro(
            JD3Q19, f_n, flags, rho, vel, c=1.0, use_pallas=False, **GAS)
        _, m0g, m1g = jstream.stream_bounce_moments(JD3Q19, g_n, flags, use_pallas=False)
        want += [rho_n, vel_n, den_n, m0g, m1g]
    out = kernels.lbm_epilogue_plain(*_args(d, T), tau_f=0.68, tau_g=0.7, emit_mac=emit_mac,
                                     mac_consts=MAC_CONSTS)
    got = list(out[:2]) + (list(out[2]) if emit_mac else [])
    assert len(out) == (3 if emit_mac else 2) and len(got) == len(want)
    names = ("f", "g", "rho", "vel", "density", "m0g", "m1g")
    for name, a, b in zip(names, got, want):
        assert a.dtype == torch.float64 and rel(a, b) <= 1e-12, f"{name}: {rel(a, b):.2e}"
    # non-fluid cells keep their bounced values
    keep = d["flags"][0, 0] != FLUID
    np.testing.assert_array_equal(got[0].numpy()[0][:, keep], np.asarray(f_post)[0][:, keep])


@pytest.mark.parametrize("res", RES)
def test_emission_is_the_prologue_on_the_collided_pair(res):
    args = _args(_fields(res, 2), T)
    f_n, g_n, mac = kernels.lbm_epilogue_plain(*args, tau_f=0.68, tau_g=0.68, emit_mac=True,
                                               mac_consts=MAC_CONSTS)
    f1, g1 = kernels.lbm_epilogue_plain(*args, tau_f=0.68, tau_g=0.68)
    assert torch.equal(f_n, f1) and torch.equal(g_n, g1)
    want = kernels.lbm_prologue_plain(f_n, g_n, args[2], args[3], args[4], c=1.0, **GAS)
    for a, b in zip(mac, want, strict=True):
        assert torch.equal(a, b)


def test_wrapper_takes_the_plain_version_on_cpu():
    d = {k: v.astype(np.float32) if v.dtype == np.float64 else v
         for k, v in _fields((6, 8, 10), 3).items()}
    args = _args(d, T)
    before = [a.clone() for a in args]
    kernels.reset_launch_counts()
    for emit in (False, True):
        got = kernels.lbm_epilogue(*args, tau_f=0.68, tau_g=0.68, emit_mac=emit,
                                   mac_consts=MAC_CONSTS)
        want = kernels.lbm_epilogue_plain(*args, tau_f=0.68, tau_g=0.68, emit_mac=emit,
                                          mac_consts=MAC_CONSTS)
        flat = lambda o: list(o[:2]) + list(o[2] if emit else ())  # noqa: E731
        for a, b in zip(flat(got), flat(want), strict=True):
            assert a.dtype == torch.float32 and torch.equal(a, b)
    assert all(torch.equal(a, b) for a, b in zip(args, before))
    assert kernels.launch_counts(["B5"]) == {"B5": 0}


@pytest.mark.slow
@pytest.mark.parametrize("compact", [False, True], ids=["full", "compact"])
@pytest.mark.parametrize("Z", [4, 7])
def test_epilogue_plain_matches_tpu_kernel(Z, compact):
    """Against the TPU kernel with ``emit_mac`` in interpret mode, in both
    of its ring layouts (the compact one is the f32 256^2-plane layout)."""
    from lbm_ferrofluid_tpu.ops.pallas.fused_step import lbm_epilogue as jepilogue

    d = {k: v.astype(np.float32) if v.dtype == np.float64 else v
         for k, v in _fields((Z, 8, 128), 4).items()}
    kw = dict(tau_f=0.68, tau_g=0.68, dx=1.0, dt=1.0)
    jf, jg, jmac = jepilogue(*_args(d, jnp.asarray), emit_mac=True, mac_consts=MAC_CONSTS,
                             compact=compact, interpret=True, **kw)
    jf1, jg1 = jepilogue(*_args(d, jnp.asarray), interpret=True, **kw)
    pf, pg, pmac = kernels.lbm_epilogue_plain(*_args(d, T), emit_mac=True,
                                              mac_consts=MAC_CONSTS, **kw)
    for a, b in [(pf, jf), (pg, jg), (pf, jf1), (pg, jg1), *zip(pmac, jmac, strict=True)]:
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=5e-7)
