"""A pytest plugin that records the ids of the tests a process runs, in
order.  The meshed test modules load it (``pytest_plugins``) so that a
bit-for-bit mismatch's record (``torch_mesh_worker.save_sides``) names the
tests that ran before it in the same process (an xdist worker's share)."""

#: the ids of the tests this process has started, the running one last
RAN: list = []


def pytest_runtest_logstart(nodeid, location):
    """Record ``nodeid`` in :data:`RAN`."""
    RAN.append(nodeid)
