"""The port's traffic model (``lbm_ferrofluid_tpu_torch/models/traffic.py``)
against the JAX package's (``lbm_ferrofluid_tpu/models/traffic.py``).

* Parity: in each of the step's three routes (the premac a state carries:
  6 leaves, 5, or none), both solve forms, three storages, three grids and
  two sweep counts, the port's bytes per cell equal JAX's to rel 1e-12 when
  JAX's TPU gates are set to the port's decisions (``emit_mac_fits`` and
  ``capillogue_fits`` to the route, ``scalar_wavefront_hint_ok`` true, the
  pass depths ``_sp_plan`` and ``_wf_plan`` to the port's k); on grids with
  under 3 cells in y or x the channel form is the psi route, JAX's branch
  of a depth under 2.  The patching lives here only.
* A sweep count that the port's depth does not divide: the remainder pass
  counted with its own k, against a hand count.
* On small CPU states: ``prime_premac`` leaves the default branch (6
  leaves), a batch of two stays un-carried, and in each case the route
  that ``ferrofluid_step`` takes (its kernels' wrappers spied on) is the
  one that the model counts for the state's premac.
* The module imports nothing of JAX or of the JAX package.
"""

import inspect
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from lbm_ferrofluid_tpu.models import traffic as jtraffic  # noqa: E402
from lbm_ferrofluid_tpu.ops.pallas import capillogue as jcap  # noqa: E402
from lbm_ferrofluid_tpu.ops.pallas import fused_step as jfused  # noqa: E402
from lbm_ferrofluid_tpu.ops.pallas import poisson as jpoisson  # noqa: E402
from lbm_ferrofluid_tpu.ops.pallas import scalar_poisson as jscalar  # noqa: E402
from lbm_ferrofluid_tpu_torch.models import ferrofluid as ff  # noqa: E402
from lbm_ferrofluid_tpu_torch.models import prime_premac, rosensweig_3d  # noqa: E402
from lbm_ferrofluid_tpu_torch.models import traffic  # noqa: E402
from lbm_ferrofluid_tpu_torch.ops.kernels import poisson, scalar_poisson  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
REL = 1e-12
STORAGES = [(4, 4), (4, 2), (2, 2)]
GRIDS = [(256, 256, 256), (130, 66, 130), (128, 128, 128)]


def _jax_bytes(monkeypatch, premac, k, n_iters, b_fg, b_h, res, scalar, took=None):
    """JAX's model with its gates set to the port's decisions: the route
    by ``premac`` (or ``took``, the (mac carry, capillogue) that a step
    took), the scalar hint on, both pass depths ``k``."""
    mac_carry, capillogue = took or (premac is not None, premac == 6)
    monkeypatch.setattr(jfused, "emit_mac_fits", lambda shape, dt: mac_carry)
    monkeypatch.setattr(jcap, "capillogue_fits", lambda shape, dt: capillogue)
    monkeypatch.setattr(jscalar, "scalar_wavefront_hint_ok", lambda shape, dt, n: True)
    monkeypatch.setattr(jscalar, "_sp_plan", lambda shape, n: k)
    monkeypatch.setattr(jpoisson, "_wf_plan", lambda shape, dt, n: k)
    return jtraffic.model_bytes_per_cell(n_iters=n_iters, b_fg=b_fg, b_h=b_h, res=res,
                                         scalar=scalar)


@pytest.mark.parametrize("n_iters", [30, 12])
@pytest.mark.parametrize("res", GRIDS, ids=lambda r: "x".join(map(str, r)))
@pytest.mark.parametrize("b_fg,b_h", STORAGES, ids=lambda b: str(b))
@pytest.mark.parametrize("scalar", [True, False], ids=["scalar", "channel"])
@pytest.mark.parametrize("premac", traffic.PREMAC_LEAVES, ids=lambda p: f"premac{p}")
def test_matches_jax_with_the_ports_gates(monkeypatch, premac, scalar, b_fg, b_h, res,
                                          n_iters):
    depths = set((scalar_poisson if scalar else poisson).passes(n_iters))
    assert len(depths) == 1, "these sweep counts are whole passes of the port's depth"
    want = _jax_bytes(monkeypatch, premac, depths.pop(), n_iters, b_fg, b_h, res, scalar)
    got = traffic.model_bytes_per_cell(n_iters, b_fg, b_h, res, scalar, premac=premac)
    assert got == pytest.approx(want, rel=REL)


@pytest.mark.parametrize("res", [(16, 2, 16), (16, 16, 2)], ids=["y2", "x2"])
@pytest.mark.parametrize("b_fg,b_h", STORAGES, ids=lambda b: str(b))
@pytest.mark.parametrize("premac", traffic.PREMAC_LEAVES, ids=lambda p: f"premac{p}")
def test_psi_route_is_jax_one_sweep_branch(monkeypatch, premac, b_fg, b_h, res):
    assert not poisson.emit_ok(res)
    want = _jax_bytes(monkeypatch, premac, 1, 30, b_fg, b_h, res, False)
    got = traffic.model_bytes_per_cell(30, b_fg, b_h, res, False, premac=premac)
    assert got == pytest.approx(want, rel=REL)


@pytest.mark.parametrize("scalar", [True, False], ids=["scalar", "channel"])
def test_remainder_pass_counted_with_its_own_depth(scalar):
    # 31 sweeps: ten passes of 3 and one of 1 in both forms
    assert (scalar_poisson if scalar else poisson).passes(31) == (3,) * 10 + (1,)
    Z = 256
    if scalar:
        def per_pass(k):
            return 8 * (2 + 3 * k / Z) + (1 + 2 * k / Z) * 8
    else:
        def per_pass(k):
            return 76 * (2 + 2 * k / Z) + (1 + 2 * k / Z) * 8
    # the capillogue steady state in float32 beside the solve: B3 + B2
    rest = (38 * 4 + 8 + 48) + 38 * 4 + 60 + (8 + 4)
    want = rest + 10 * per_pass(3) + per_pass(1) + 4
    got = traffic.model_bytes_per_cell(31, res=(Z, Z, Z), scalar=scalar)
    assert got == pytest.approx(want, rel=REL)


def test_rejects_what_the_port_does_not_step():
    with pytest.raises(ValueError):
        traffic.model_bytes_per_cell(premac=4)
    with pytest.raises(ValueError):
        traffic.model_bytes_per_cell(n_iters=0)
    with pytest.raises(ValueError):
        traffic.model_bytes_per_cell(res=(16, 2, 16), scalar=True)


def _spy(monkeypatch, seen):
    """Record the step's stage wrappers as it calls them."""
    for name, tag in (("lbm_prologue", "prologue"), ("lbm_capillogue", "capillogue"),
                      ("lbm_epilogue", "epilogue"), ("solve_H_int_scalar", "scalar"),
                      ("solve_H_int", "channel")):
        fn = getattr(ff, name)

        def wrapped(*args, _fn=fn, _tag=tag, **kw):
            seen.append(_tag + (" emit_mac" if kw.get("emit_mac") else ""))
            return _fn(*args, **kw)

        monkeypatch.setattr(ff, name, wrapped)


def _state(form):
    if form == "batch of two":
        params, st = rosensweig_3d(res=(8, 16, 16), batch=2, device="cpu")
        return params, prime_premac(params, st, device="cpu")
    params, st = rosensweig_3d(res=(8, 16, 16), device="cpu")
    st = prime_premac(params, st, device="cpu")
    return params, st.replace(premac=st.premac[:5]) if form == "five leaves" else st


@pytest.mark.parametrize("form", ["primed", "five leaves", "batch of two"])
def test_branch_is_the_route_the_step_takes(monkeypatch, form):
    params, st = _state(form)
    premac = None if st.premac is None else len(st.premac)
    scalar = st.h.shape[1] == 2
    if form == "primed":
        assert premac == inspect.signature(
            traffic.model_bytes_per_cell).parameters["premac"].default == 6
        assert scalar
    if form == "batch of two":
        assert premac is None and not scalar
    seen = []
    _spy(monkeypatch, seen)
    out = ff.ferrofluid_step(params, st, device="cpu")
    assert torch.isfinite(out.f).all()
    # the route the step took, as JAX's gates name it
    capillogue = "capillogue" in seen
    mac_carry = capillogue or "epilogue emit_mac" in seen
    assert ("prologue" in seen) == (not mac_carry)
    assert ("scalar" in seen) == scalar and ("channel" in seen) == (not scalar)
    assert (6 if capillogue else 5 if mac_carry else None) == premac
    # the model's branch for the state's premac is JAX's for that route
    res = tuple(st.f.shape[2:])
    k = (scalar_poisson if scalar else poisson).passes(params.poisson_iters)[0]
    want = _jax_bytes(monkeypatch, None, k, params.poisson_iters, 4, 4, res, scalar,
                      took=(mac_carry, capillogue))
    got = traffic.model_bytes_per_cell(params.poisson_iters, res=res, scalar=scalar,
                                       premac=premac)
    assert got == pytest.approx(want, rel=REL)


def test_imports_nothing_of_jax():
    code = (
        "import sys\n"
        "import lbm_ferrofluid_tpu_torch.models.traffic as t\n"
        "assert t.model_bytes_per_cell() > 0\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'lbm_ferrofluid_tpu')]\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
