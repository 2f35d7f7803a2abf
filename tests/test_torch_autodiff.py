"""Differentiable simulation through the port, and the guard that keeps
autograd away from the CUDA kernels.

* The two losses of tests/test_autodiff.py (2D HCZ 16x16, 3 steps;
  ``rosensweig_2d`` 16x16 at mag 20 with ``poisson_iters=3``, 2 steps),
  d(loss)/d(initial rho) through the port's plain steps in float64: against
  ``jax.grad`` of the JAX steps within 1e-9 relative (slow, as the JAX file,
  since it traces ``jax.grad``), and against central finite differences at
  the largest fluid-cell gradients (fast).
* ``demo/demo_inverse_design.py``'s port at ``--iters 3`` on the CPU: its
  three losses equal the JAX driver's optax loop within 1e-5 relative in
  float32; ``torch.optim.Adam`` takes ``optax.adam``'s update (both bias
  corrections, epsilon outside the square root) within 1e-12 in float64.
* ``ops/kernels/_lib.py:check_no_grad``: it raises under autograd when an
  input requires grad, and every kernel wrapper in ``KERNELS`` calls it
  before any other check (chip_smoke.py's ``grad_guard`` calls on ``meta``
  tensors, which take the kernel branch without a card); the plain
  versions stay differentiable.
"""

import dataclasses
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402

from lbm_ferrofluid_tpu_torch.demo import demo_inverse_design  # noqa: E402
from lbm_ferrofluid_tpu_torch.models import (  # noqa: E402
    ferrofluid_step,
    hcz_step,
    scenes as tscenes,
)
from lbm_ferrofluid_tpu_torch.ops import kernels  # noqa: E402
from lbm_ferrofluid_tpu_torch.ops.kernels._lib import check_no_grad  # noqa: E402
from lbm_ferrofluid_tpu_torch.utils.types import CellType  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    """One PyTorch thread: the tier-1 run puts six test processes on the
    machine's cores, and PyTorch's default pool would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _float64(state):
    return state.replace(**{
        f.name: getattr(state, f.name).double() for f in dataclasses.fields(state)
        if torch.is_tensor(getattr(state, f.name)) and getattr(state, f.name).is_floating_point()
    })


def _case(name):
    """(params, float64 state, step, n_steps, loss of the final state) of
    tests/test_autodiff.py's two losses, on the port."""
    if name == "hcz":
        params, state = tscenes.multiphase_drop_hcz((16, 16), device="cpu")
        return params, _float64(state), hcz_step, 3, lambda s: torch.mean(
            (s.rho - torch.mean(s.rho)) ** 2)
    params, state = tscenes.rosensweig_2d((16, 16), mag_strength=20.0, device="cpu")
    return (params.replace(poisson_iters=3), _float64(state), ferrofluid_step, 2,
            lambda s: torch.mean(s.vel * s.vel) + torch.mean(s.rho * s.rho))


def _loss_fn(name):
    params, state, step, n, final = _case(name)

    def loss(rho0):
        s = state.replace(rho=rho0)
        for _ in range(n):
            s = step(params, s, device="cpu")
        return final(s)

    return loss, state


def _grad(name):
    loss, state = _loss_fn(name)
    rho = state.rho.clone().requires_grad_(True)
    loss(rho).backward()
    return loss, state, rho.grad


def _fd_check(loss, x0, g, eps=1e-3, rtol=2e-2, mask=None):
    """tests/test_autodiff.py's check: the central difference at the
    max-|grad| entry (restricted to ``mask``: wall cells sit on clamp
    boundaries, where AD's subgradient and central differences
    legitimately disagree)."""
    gm = torch.where(mask, g, 0.0) if mask is not None else g
    i = int(gm.abs().flatten().argmax())
    xp, xm = x0.clone(), x0.clone()
    xp.view(-1)[i] += eps
    xm.view(-1)[i] -= eps
    with torch.no_grad():
        fd = (float(loss(xp)) - float(loss(xm))) / (2 * eps)
    ad = float(g.view(-1)[i])
    assert abs(ad - fd) <= rtol * max(abs(fd), 1e-8), f"AD {ad} vs FD {fd} at {i}"


@pytest.mark.parametrize("name", ["hcz", "ferrofluid"])
def test_grad_matches_finite_differences(name):
    """tests/test_autodiff.py's checks through the port's plain steps.  The
    step recomputes rho at fluid cells from the streamed f, so d/d(rho0)
    lives at the walls; the fluid-restricted check reads it there as the
    JAX file does."""
    loss, state, g = _grad(name)
    assert torch.isfinite(g).all() and g.abs().sum() > 0
    _fd_check(loss, state.rho, g, mask=state.flags == int(CellType.FLUID))


def test_grad_wrt_f_matches_finite_differences():
    """d(loss)/d(initial f) of the HCZ loss, which reaches every fluid
    cell: central differences at the three largest fluid entries, in
    float64."""
    params, state, step, n, final = _case("hcz")

    def loss(f0):
        s = state.replace(f=f0)
        for _ in range(n):
            s = step(params, s, device="cpu")
        return final(s)

    f = state.f.clone().requires_grad_(True)
    loss(f).backward()
    fluid = (state.flags == int(CellType.FLUID)).expand_as(f.grad)
    gm = torch.where(fluid, f.grad, 0.0).abs().flatten()
    assert int((gm > 0).sum()) > 100
    eps = 1e-6
    with torch.no_grad():
        for i in gm.topk(3).indices.tolist():
            xp, xm = state.f.clone(), state.f.clone()
            xp.view(-1)[i] += eps
            xm.view(-1)[i] -= eps
            fd = (float(loss(xp)) - float(loss(xm))) / (2 * eps)
            ad = float(f.grad.view(-1)[i])
            assert abs(ad - fd) <= 1e-6 * abs(fd), (i, ad, fd)


@pytest.mark.slow
@pytest.mark.parametrize("name", ["hcz", "ferrofluid"])
def test_grad_matches_jax_grad(name):
    import jax
    import jax.numpy as jnp

    from lbm_ferrofluid_tpu.models import ferrofluid_step_impl, hcz_step_impl
    from lbm_ferrofluid_tpu.models import scenes as jscenes

    if name == "hcz":
        params, state = jscenes.multiphase_drop_hcz((16, 16))
        step, n = hcz_step_impl, 3
        params = params.replace(use_pallas=False)

        def final(s):
            return jnp.mean((s.rho - jnp.mean(s.rho)) ** 2)
    else:
        params, state = jscenes.rosensweig_2d((16, 16), mag_strength=20.0)
        step, n = ferrofluid_step_impl, 2
        params = params.replace(use_pallas=False, poisson_iters=3)

        def final(s):
            return jnp.mean(s.vel * s.vel) + jnp.mean(s.rho * s.rho)

    state = jax.tree_util.tree_map(
        lambda x: jnp.asarray(np.asarray(x, np.float64) if np.asarray(x).dtype == np.float32
                              else np.asarray(x)), state)

    def loss(rho0):
        s = dataclasses.replace(state, rho=rho0)
        for _ in range(n):
            s = step(params, s)
        return final(s)

    g_j = np.asarray(jax.grad(loss)(state.rho))
    _, _, g_t = _grad(name)
    assert g_t.dtype == torch.float64 and np.abs(g_j).max() > 0
    err = np.abs(g_t.numpy() - g_j).max() / np.abs(g_j).max()
    assert err <= 1e-9, err


def _jax_driver_losses(res, steps, iters, lr):
    """The JAX driver's loop (demo/demo_inverse_design.py:47-86): the
    losses before each optax Adam update."""
    import jax
    import jax.numpy as jnp
    import optax

    from lbm_ferrofluid_tpu.models import hcz_step_impl
    from lbm_ferrofluid_tpu.models import scenes as jscenes

    params, state0 = jscenes.multiphase_drop_hcz(tuple(res))
    params = params.replace(use_pallas=False)
    snap = jax.tree_util.tree_map(lambda x: np.asarray(x).copy(), state0)

    def forward(rho0):
        s = dataclasses.replace(jax.tree_util.tree_map(jnp.asarray, snap), rho=rho0)
        for _ in range(steps):
            s = hcz_step_impl(params, s)
        return s.rho

    H, W = res
    target = forward(jnp.asarray(np.roll(snap.rho, (H // 8, W // 8), axis=(-2, -1))))

    def loss_fn(rho0):
        d = forward(rho0) - target
        return jnp.mean(d * d)

    tx = optax.adam(lr)
    rho = jnp.asarray(snap.rho)
    opt_state = tx.init(rho)

    @jax.jit
    def step_opt(rho, opt_state):
        loss, g = jax.value_and_grad(loss_fn)(rho)
        updates, opt_state = tx.update(g, opt_state)
        return optax.apply_updates(rho, updates), opt_state, loss

    losses = []
    for _ in range(iters):
        rho, opt_state, loss = step_opt(rho, opt_state)
        losses.append(float(loss))
    return losses


def test_inverse_design_demo_matches_jax_driver(tmp_path):
    out = demo_inverse_design.main(["--iters", "3", "--device", "cpu", "--out_dir",
                                    str(tmp_path)])
    for png in ("initial_final.png", "target_final.png", "optimized_final.png"):
        assert (tmp_path / png).exists()
    want = _jax_driver_losses((24, 24), 4, 3, 0.02)
    np.testing.assert_allclose(out["losses"], want, rtol=1e-5)
    assert out["final"] < 0.5 * out["losses"][0]


def test_inverse_design_demo_fails_without_a_2x_fall(tmp_path):
    with pytest.raises(SystemExit, match="2x"):
        demo_inverse_design.main(["--iters", "1", "--device", "cpu", "--out_dir",
                                  str(tmp_path)])


def test_torch_adam_is_optax_adam():
    import jax.numpy as jnp
    import optax

    rng = np.random.default_rng(0)
    x0 = rng.normal(size=(7, 5))
    scale = rng.uniform(1e-9, 10.0, size=x0.shape)  # gradients near and far from eps

    tx = optax.adam(0.02)
    xj = jnp.asarray(x0)
    st = tx.init(xj)
    xt = torch.tensor(x0, requires_grad=True)
    adam = torch.optim.Adam([xt], lr=0.02)
    for _ in range(6):
        gj = jnp.asarray(scale) * xj
        upd, st = tx.update(gj, st)
        xj = optax.apply_updates(xj, upd)
        adam.zero_grad()
        (0.5 * torch.sum(torch.from_numpy(scale) * xt * xt)).backward()
        adam.step()
        np.testing.assert_allclose(xt.detach().numpy(), np.asarray(xj), rtol=1e-12, atol=1e-15)


def test_check_no_grad_raises_only_under_autograd():
    a = torch.zeros(3, requires_grad=True)
    b = torch.zeros(3)
    with pytest.raises(RuntimeError, match="B-name: .*plain=True, or device='cpu'"):
        check_no_grad("B-name", b, None, a)
    check_no_grad("B-name", b, None)
    with torch.no_grad():
        check_no_grad("B-name", a)


@pytest.mark.parametrize("kid", sorted(kernels.KERNELS))
def test_every_wrapper_checks_grad_first(kid):
    """chip_smoke.py's grad_guard calls on ``meta`` tensors: the guard
    raises under autograd, and under ``no_grad`` the call goes on to the
    device check."""
    wrapper = kernels.KERNELS[kid].wrapper
    calls = chip_smoke.grad_guard_calls("meta")
    assert sorted(calls) == sorted(kernels.KERNELS)
    with pytest.raises(RuntimeError, match=f"{wrapper.__name__}: an input requires grad"):
        calls[kid](wrapper)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA tensor"):
        calls[kid](wrapper)
    assert all(n == 0 for n in kernels.launch_counts().values())


def test_plain_versions_stay_differentiable():
    params, state = tscenes.multiphase_3d((6, 8, 10), device="cpu")
    rho = state.rho.clone().requires_grad_(True)
    out = kernels.contact_angle_3d(rho, state.flags, params.contact_angle)
    lap = kernels.laplacian_field(out, dx=1.0)
    grads = kernels.grad_fields(torch.cat([lap, out], dim=1), dx=1.0)
    grads.square().sum().backward()
    assert torch.isfinite(rho.grad).all() and rho.grad.abs().sum() > 0
