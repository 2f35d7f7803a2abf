"""B11b's pass schedule replayed on the CPU, bit for bit against the plain
sweeps in float32 at 30 and 7 sweeps and tau 1 and 0.8: the plan's own
choice at a 7x30x29 grid, 2 x 2 tiles (``SCHEDULES[:1]`` of
tests/poisson_replay.py; the replay and the rest of the plan's tests are
described in tests/test_torch_poisson_plan.py).
"""

import pytest

torch = pytest.importorskip("torch")

from poisson_replay import SCHEDULES, replay_against_plain  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    """The replay is thousands of small tensor ops: on one thread each, so
    that the test workers' thread pools do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("tau", [1.0, 0.8])
@pytest.mark.parametrize("n_iters", [30, 7])
@pytest.mark.parametrize("res,tile", SCHEDULES[:1])
def test_schedule_equals_plain_sweeps_bit_for_bit(res, tile, n_iters, tau):
    replay_against_plain(res, tile, n_iters, tau, torch.float32)
