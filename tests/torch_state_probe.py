"""A pytest plugin that checks the port's process state after each test
file (ROADMAP C11: a meshed test's one-device reference, computed in the
test process, was once wrong after other tests had run there).

After the last test of each file it takes a fingerprint of the process:
every numpy array and tensor held at module level by the port's modules
(and the numpy arrays of dataclasses held there: the lattices), the
sizes of the port's ``functools.lru_cache`` tables, torch's and numpy's
global settings, whether float32 denormals survive a multiply, and the
hashes of route C's one-device reference (``test_torch_parallel_channel.
port_steps("C", 3)``'s f, g, h and rho, at 2 threads as that test runs
it).  Each line of the output (``TORCH_STATE_PROBE_OUT``, default
``torch_state_probe.jsonl`` in the working directory) is one file's
check: the fields that differ from the fingerprint taken after
collection, before any test ran.  Run
it over the test files in one process::

    PYTHONPATH=tests JAX_PLATFORMS=cpu python -m pytest tests/test_torch_*.py \
        -m 'not slow' -p torch_state_probe -p no:randomly -p no:cacheprovider -q
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import sys

import numpy as np

PREFIX = "lbm_ferrofluid_tpu_torch"


def _digest(x) -> str:
    import torch

    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        x = (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).contiguous().numpy()
    return hashlib.sha256(np.ascontiguousarray(x).tobytes()).hexdigest()[:16]


def module_state() -> dict:
    """{name: digest or size} of what the port's modules hold."""
    import torch

    out = {}
    for mname, mod in sorted(sys.modules.items()):
        if not mname.startswith(PREFIX) or mod is None:
            continue
        for attr, v in sorted(vars(mod).items()):
            key = f"{mname}.{attr}"
            if isinstance(v, (np.ndarray, torch.Tensor)):
                out[key] = _digest(v)
            elif dataclasses.is_dataclass(v) and not isinstance(v, type):
                for f in dataclasses.fields(v):
                    a = getattr(v, f.name)
                    if isinstance(a, (np.ndarray, torch.Tensor)):
                        out[f"{key}.{f.name}"] = _digest(a)
            if callable(getattr(v, "cache_info", None)) and getattr(v, "__module__", "") == mname:
                out[f"{key}.cache_size"] = v.cache_info().currsize
    return out


def global_state() -> dict:
    import torch

    tiny = torch.tensor([1e-39], dtype=torch.float32)
    return {
        "torch.num_threads": torch.get_num_threads(),
        "torch.default_dtype": str(torch.get_default_dtype()),
        "torch.deterministic": torch.are_deterministic_algorithms_enabled(),
        "torch.grad_enabled": torch.is_grad_enabled(),
        "torch.matmul_precision": torch.get_float32_matmul_precision(),
        "torch.mkldnn": torch.backends.mkldnn.enabled,
        "torch.cpu_capability": torch.backends.cpu.get_cpu_capability(),
        "torch.denormals_kept": bool((tiny * 1.0).item() != 0.0),
        "numpy.denormals_kept": bool(np.float32(1e-39) * np.float32(1.0) != 0.0),
        "numpy.errstate": str(sorted(np.geterr().items())),
    }


def reference_state() -> dict:
    import torch

    import test_torch_parallel_channel as chan

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        s = chan.port_steps("C", 3)
    finally:
        torch.set_num_threads(n)
    return {f"route_C.{k}": _digest(getattr(s, k)) for k in ("f", "g", "h", "rho")}


def fingerprint() -> dict:
    return {**module_state(), **global_state(), **reference_state()}


class _Probe:
    def __init__(self):
        self.first = None
        self.out = os.environ.get("TORCH_STATE_PROBE_OUT", "torch_state_probe.jsonl")

    def pytest_collection_finish(self, session):
        self.first = fingerprint()

    def pytest_runtest_teardown(self, item, nextitem):
        if nextitem is not None and nextitem.path == item.path:
            return
        now = fingerprint()
        diff = {k: [self.first.get(k), v] for k, v in now.items() if self.first.get(k) != v}
        diff.update({k: [v, None] for k, v in self.first.items() if k not in now})
        with open(self.out, "a") as fh:
            fh.write(json.dumps({"after": str(item.path.name), "differs": diff}) + "\n")


def pytest_configure(config):
    config.pluginmanager.register(_Probe(), "torch_state_probe_instance")
