"""Device selection for the port's entry points.

Every entry point (scene builders, ``init_hcz_state``, ``hcz_step``,
``init_ferrofluid_state``, ``prime_premac``, ``ferrofluid_step``,
``SimulationRunner``) takes a
``device`` argument.  ``None`` means the card: without CUDA the call raises
instead of carrying on quietly on the CPU.  ``device="cpu"`` runs the plain
PyTorch versions of the kernels, as the tests do.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device", "check_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raise if CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested (the default) but torch.cuda.is_available()"
            " is False; pass device='cpu' to run the plain PyTorch versions"
        )
    return dev


def check_device(tensor: torch.Tensor, device=None) -> torch.device:
    """Resolve ``device`` and check that ``tensor`` lives on it."""
    dev = resolve_device(device)
    if tensor.device.type != dev.type:
        raise ValueError(
            f"state lives on {tensor.device}, but device={dev} was requested"
        )
    return dev
