"""Checkpoint and resume of states.

Port of ``lbm_ferrofluid_tpu/utils/checkpoint.py``: one .npz of the
state's array leaves, keyed as ``jax.tree_util.keystr`` names the JAX
state's leaves (``.f``, ``.H_ext_mac[0]``, ``.premac[5]``, ``.step``), so a
checkpoint of either package loads into a template of the other.  None
fields are no leaves; tuple fields give one leaf an element.  bfloat16
leaves are stored widened to float32 (exact), since numpy's npz has no
bfloat16, and cast back to the template's type on load.  ``step`` is
stored as an int32 scalar, as the JAX state holds it.
"""

from __future__ import annotations

import dataclasses
import pathlib

import numpy as np
import torch

__all__ = ["save_checkpoint", "load_checkpoint", "leaf_paths"]


def leaf_paths(state):
    """``(key, value)`` for each leaf of ``state`` in field order: a tensor,
    or the int ``step``."""
    out = []
    for fld in dataclasses.fields(state):
        value = getattr(state, fld.name)
        if value is None:
            continue
        if isinstance(value, (tuple, list)):
            out += [(f".{fld.name}[{i}]", v) for i, v in enumerate(value)]
        else:
            out.append((f".{fld.name}", value))
    return out


def save_checkpoint(path, state) -> None:
    """Write every leaf of ``state`` to ``path`` (.npz)."""
    arrays = {}
    for key, leaf in leaf_paths(state):
        if torch.is_tensor(leaf):
            leaf = leaf.detach()
            if leaf.dtype == torch.bfloat16:
                leaf = leaf.float()
            arrays[key] = leaf.cpu().numpy()
        else:
            arrays[key] = np.asarray(leaf, np.int32)
    pathlib.Path(path).parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **arrays)


def load_checkpoint(path, template):
    """A state with ``template``'s structure, leaf types and device, its
    leaves read from ``path``."""
    data = np.load(path)
    values = {}
    for key, leaf in leaf_paths(template):
        if key not in data:
            raise KeyError(f"checkpoint {path} missing leaf {key}")
        arr = data[key]
        if torch.is_tensor(leaf):
            value = torch.as_tensor(np.array(arr)).to(device=leaf.device, dtype=leaf.dtype)
        else:
            value = int(arr)
        values[key] = value
    kw = {}
    for fld in dataclasses.fields(template):
        value = getattr(template, fld.name)
        if value is None:
            continue
        if isinstance(value, (tuple, list)):
            kw[fld.name] = tuple(values[f".{fld.name}[{i}]"] for i in range(len(value)))
        else:
            kw[fld.name] = values[f".{fld.name}"]
    return dataclasses.replace(template, **kw)
