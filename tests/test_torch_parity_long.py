"""Long-horizon golden parity through the port: 400 steps of the 2D
two-droplets ferrofluid (tests/golden/two_droplets_400.npz, the reference
solver in float64 at 49x96, mag 100, 30 Poisson sweeps a step; ROADMAP
A14).

The port runs on the CPU in float64, in the channel form (float64 h has no
scalar carry), from the golden's fields; it reads only the golden and the
port.  The bars are tests/test_parity_long.py's, including the droplet
merge: one 4-connected fluid body at step 400 in both solvers.  Their
floor is the reference's float32-rounded lattice weight tables (3.3e-9
relative), which neither package copies: the JAX package measures 3.7e-7
in density at step 100 and 2.2e-6 at step 400.
"""

import pathlib

import numpy as np
import pytest
import torch

from lbm_ferrofluid_tpu_torch.models import (
    SimulationParams,
    SimulationRunner,
    ferrofluid_step,
    init_ferrofluid_state,
)

GOLDEN = pathlib.Path(__file__).parent / "golden" / "two_droplets_400.npz"


def _components(mask):
    """Number of 4-connected components of a 2D boolean mask."""
    mask = np.asarray(mask)
    seen = np.zeros_like(mask, dtype=bool)
    n = 0
    H, W = mask.shape
    for j0 in range(H):
        for i0 in range(W):
            if mask[j0, i0] and not seen[j0, i0]:
                n += 1
                stack = [(j0, i0)]
                seen[j0, i0] = True
                while stack:
                    j, i = stack.pop()
                    for dj, di in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                        jj, ii = j + dj, i + di
                        if 0 <= jj < H and 0 <= ii < W and mask[jj, ii] and not seen[jj, ii]:
                            seen[jj, ii] = True
                            stack.append((jj, ii))
    return n


def test_components_counts_bodies():
    m = np.zeros((5, 7), bool)
    m[1, 1] = m[1, 2] = m[3, 5] = True
    assert _components(m) == 2
    m[2, 2:6] = True  # a bridge between the two
    assert _components(m) == 1
    m[0, 6] = True  # diagonal neighbours are not 4-connected
    assert _components(m) == 2


def test_two_droplets_400_step_parity():
    d = np.load(GOLDEN)
    params = SimulationParams(
        dim=2, density_gas=0.02381, density_fluid=0.2508,
        rho_gas=0.02381, rho_fluid=0.2508,
        kappa=0.5, tau_f=0.68, tau_g=0.68,
        gravity=float(d["gravity"]), mag_strength=float(d["mag"]),
        poisson_iters=30, fg_dtype="float64", h_dtype="float64",
    )
    flags = d["flags"]
    res = flags.shape[2:]
    state = init_ferrofluid_state(
        params, d["rho0"].astype(np.float64), d["den0"].astype(np.float64),
        np.zeros((1, 2, *res), np.float64), flags, flags, device="cpu",
    )
    n = torch.get_num_threads()
    torch.set_num_threads(1)  # a 2D step is thousands of small ops
    try:
        runner = SimulationRunner(params, ferrofluid_step, device="cpu")
        state = runner.run(state, 100)
        assert state.h.shape[1] == 9 and state.h.dtype == torch.float64  # the channel form
        np.testing.assert_allclose(state.density.numpy(), d["den_100"], rtol=1e-5, atol=2e-6,
                                   err_msg="density @100")
        np.testing.assert_allclose(state.vel.numpy(), d["vel_100"], rtol=1e-4, atol=5e-7,
                                   err_msg="vel @100")
        state = runner.run(state, int(d["steps"]) - 100)
    finally:
        torch.set_num_threads(n)
    assert state.step == int(d["steps"]) == 400
    got = state.density.numpy()
    np.testing.assert_allclose(got, d["den_400"], rtol=1e-4, atol=1e-5, err_msg="density @400")
    np.testing.assert_allclose(state.pressure.numpy(), d["p_400"], rtol=1e-4, atol=1e-6,
                               err_msg="pressure @400")
    mid = 0.5 * (params.density_gas + params.density_fluid)
    interior = (slice(None), slice(None), slice(1, -1), slice(1, -1))
    assert _components((d["den_400"][interior] > mid)[0, 0]) == 1
    assert _components((got[interior] > mid)[0, 0]) == 1
