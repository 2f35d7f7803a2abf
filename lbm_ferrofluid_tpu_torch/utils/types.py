"""Cell-type flags, KBC collision variants, and the compute type of a
stored distribution.

``CellType`` and ``KBCType`` copy ``lbm_ferrofluid_tpu/utils/types.py``
(the port imports nothing of the JAX package), which mirrors the
reference's enums (src/LBM/utils/types.py:7-104) so scene descriptions and
golden data are interchangeable.  Flag grids are uint8 tensors compared
against ``int(CellType.X)``.
"""

from __future__ import annotations

from enum import IntEnum

import torch

__all__ = ["CellType", "KBCType", "widen", "celltype_colormap"]


def widen(t: torch.Tensor) -> torch.Tensor:
    """``t`` in the type the port computes in: a bfloat16 distribution
    upcast (exactly) to float32, float32 and float64 as they are.  bfloat16
    f/g/h is storage only, as in the JAX package: arithmetic on a bfloat16
    tensor and a Python float would stay bfloat16 in PyTorch, so every op
    widens its stored distributions before it computes and rounds back
    (``.to(dtype)``, round to nearest even) only where the JAX package
    stores."""
    return t.float() if t.dtype == torch.bfloat16 else t


class CellType(IntEnum):
    """Bitmask cell classification (reference: utils/types.py:7-15)."""

    NOTHING = 0
    FLUID = 1
    OBSTACLE = 2
    EMPTY = 4
    INFLOW = 8
    OUTFLOW = 16
    OPEN = 32
    STICK = 64

    @staticmethod
    def get_colormap():
        return celltype_colormap()


def celltype_colormap():
    """Matplotlib colormap, formatter, norm and bins for plotting flag
    fields (reference: utils/types.py:20-58).  Imports matplotlib."""
    import matplotlib
    import matplotlib.ticker
    import numpy as np
    from matplotlib.colors import BoundaryNorm, ListedColormap

    col_dict = {
        0: "black", 1: "blue", 2: "grey", 4: "white",
        8: "green", 16: "red", 32: "yellow", 64: "orange",
    }
    cm = ListedColormap([col_dict[x] for x in col_dict])
    labels = np.array([
        "NOTHING", "FLUID", "OBSTACLE", "EMPTY",
        "INFLOW", "OUTFLOW", "OPEN", "STICK",
    ])
    norm_bins = np.sort(list(col_dict)) + 0.5
    norm_bins = np.insert(norm_bins, 0, np.min(norm_bins) - 1.0)
    norm = BoundaryNorm(norm_bins, len(labels), clip=True)
    fmt = matplotlib.ticker.FuncFormatter(lambda x, pos: labels[norm(x)])
    return cm, fmt, norm, norm_bins


class KBCType(IntEnum):
    """Entropic-KBC variant selector (reference: utils/types.py:61-104).

    Bit layout: 0b1000_0000 marks "is KBC"; low bits select which moments
    live in the shear part ``s`` (A/C keep N, A/B use central moments).
    """

    LBGK = 0
    KBC_A = 0b10000101
    KBC_B = 0b10000110
    KBC_C = 0b10001001
    KBC_D = 0b10001010

    @staticmethod
    def is_KBC(v) -> bool:
        return v is not None and (int(v) & 0b10000000) > 0

    @staticmethod
    def is_KBC_AC(v) -> bool:
        return v is not None and (int(v) & 0b10000001) > 0

    @staticmethod
    def is_KBC_BD(v) -> bool:
        return v is not None and (int(v) & 0b10000010) > 0

    @staticmethod
    def is_KBC_AB(v) -> bool:
        return v is not None and (int(v) & 0b10000100) > 0

    @staticmethod
    def is_KBC_CD(v) -> bool:
        return v is not None and (int(v) & 0b10001000) > 0
