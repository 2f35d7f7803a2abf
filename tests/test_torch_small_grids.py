"""Grids with an axis of 3 cells on the port's plain path, against the JAX steps.

The JAX package gates only its kernels at 4 cells an axis and steps smaller
grids through jnp; the port's plain versions (the CPU, or ``plain=True``)
step them too.  From the same numpy state, 3 port steps on the CPU track 3
JAX steps (``use_pallas=False``) of ``hcz_step`` on ``multiphase_3d`` and
of ``ferrofluid_step`` on ``rosensweig_3d``, un-carried and primed (the
port primes to the capillogue steady state, the JAX step runs the same
function un-primed; h through ``compare_views`` where the port carries the
scalar pair).  Bars: float64 rel <= 1e-10 (the same formulas, sums
associated differently); float32 rel <= 5e-5 per field with velocities
also passing at abs <= 5e-6 (``docs/PARITY.md:78-93``); h relative to at
least 1 (see ``H_FLOOR``).  On the card, the kernel route refuses such a
grid and names ``plain=True``.
"""

import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lbm_ferrofluid_tpu import models as jmodels  # noqa: E402
from lbm_ferrofluid_tpu.models import scenes as jscenes  # noqa: E402

from lbm_ferrofluid_tpu_torch.models import (  # noqa: E402
    SimulationParams,
    ferrofluid_step,
    from_numpy,
    hcz_step,
    prime_premac,
)
from lbm_ferrofluid_tpu_torch.models.multiphase import check_kernel_grid  # noqa: E402
from lbm_ferrofluid_tpu_torch.ops.scalar_poisson import compare_views  # noqa: E402

GRIDS = [(3, 8, 16), (8, 3, 16)]
BARS = {"float64": 1e-10, "float32": 5e-5}
VEL_ABS = 5e-6
#: h is held relative to at least 1: at (8, 3, 16) the field is along y and
#: every fluid cell lies between the two y walls, so the Poisson source
#: vanishes; the port's h stays 0 and the JAX step's is rounding (2e-6 in
#: float32, 2e-15 in float64, where h reaches about 26 at (3, 8, 16))
H_FLOOR = 1.0
HCZ_FIELDS = ("f", "g", "rho", "density", "vel", "pressure", "force")
FERRO_FIELDS = ("f", "g", "rho", "density", "vel", "pressure", "h")


def _fields(state):
    def conv(v):
        if v is None:
            return None
        if isinstance(v, tuple):
            return tuple(conv(x) for x in v)
        return np.asarray(v)
    return {f.name: conv(getattr(state, f.name)) for f in dataclasses.fields(state)}


def _as_dtype(jp, js, dtype):
    """The JAX scene's params and state with f/g/h storage and every float
    field in ``dtype``."""
    if dtype == "float32":
        return jp, js

    def conv(v):
        if isinstance(v, tuple):
            return tuple(conv(x) for x in v)
        if v is not None and np.issubdtype(np.asarray(v).dtype, np.floating):
            return jnp.asarray(np.asarray(v, np.float64))
        return v
    return (jp.replace(fg_dtype="float64", h_dtype="float64"),
            dataclasses.replace(js, **{f.name: conv(getattr(js, f.name))
                                       for f in dataclasses.fields(js)}))


def _check(ps, js, names, dtype, h_views=False):
    for name in names:
        a = getattr(ps, name)
        b = np.asarray(getattr(js, name), np.float64)
        if name == "h" and h_views:
            a, b = compare_views(a, torch.as_tensor(b, dtype=a.dtype), ps.magnetic_flags)
            b = b.double().numpy()
        a = a.double().numpy()
        assert a.shape == b.shape, name
        assert np.isfinite(a).all(), name
        err = np.abs(a - b).max()
        rel = err / max(np.abs(b).max(), H_FLOOR if name == "h" else 1e-300)
        ok = rel <= BARS[dtype] or (dtype == "float32" and name == "vel" and err <= VEL_ABS)
        assert ok, f"{name}: rel {rel:.2e}, abs {err:.2e}"


def _steps(jp, js, port_step, prime=False):
    pp = SimulationParams.from_json(jp.to_json())
    ps = from_numpy(_fields(js), device="cpu")
    if prime:
        ps = prime_premac(pp, ps, device="cpu")
    jpp = jp.replace(use_pallas=False)
    jstep = jmodels.hcz_step if port_step is hcz_step else jmodels.ferrofluid_step
    for _ in range(3):
        js = jstep(jpp, js)
        ps = port_step(pp, ps, device="cpu")
    assert ps.step == int(js.step) == 3
    return ps, js


@pytest.mark.parametrize("dtype", sorted(BARS))
@pytest.mark.parametrize("res", GRIDS, ids=str)
def test_hcz_steps_a_three_cell_axis_as_jax(res, dtype):
    jp, js = _as_dtype(*jscenes.multiphase_3d(res=res), dtype)
    ps, js = _steps(jp, js, hcz_step)
    assert ps.f.dtype == getattr(torch, dtype)
    _check(ps, js, HCZ_FIELDS, dtype)


@pytest.mark.parametrize("route", ["uncarried", "primed"])
@pytest.mark.parametrize("dtype", sorted(BARS))
@pytest.mark.parametrize("res", GRIDS, ids=str)
def test_ferrofluid_steps_a_three_cell_axis_as_jax(res, dtype, route):
    jp, js = _as_dtype(*jscenes.rosensweig_3d(res=res), dtype)
    ps, js = _steps(jp, js, ferrofluid_step, prime=route == "primed")
    assert (ps.premac is None) == (route == "uncarried")
    _check(ps, js, FERRO_FIELDS, dtype, h_views=ps.h.shape[1] == 2)


@pytest.mark.parametrize("res", GRIDS + [(4, 8, 16)], ids=str)
def test_kernel_route_on_the_card_refuses_a_three_cell_axis(res):
    """Only the kernels refuse: a CUDA state's grid, without plain=True."""
    f = types.SimpleNamespace(device=torch.device("cuda"), shape=(1, 19, *res))
    if min(res) < 4:
        with pytest.raises(ValueError, match=r"plain=True") as info:
            check_kernel_grid(f, plain=False)
        assert str(tuple(res)) in str(info.value) and "B2" in str(info.value)
    else:
        check_kernel_grid(f, plain=False)
    check_kernel_grid(f, plain=True)
    check_kernel_grid(types.SimpleNamespace(device=torch.device("cpu"), shape=f.shape), False)
