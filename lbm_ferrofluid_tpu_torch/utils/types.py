"""Cell-type flags and KBC collision variants.

Copy of ``lbm_ferrofluid_tpu/utils/types.py`` (the port imports nothing of
the JAX package), which mirrors the reference's enums
(src/LBM/utils/types.py:7-104) so scene descriptions and golden data are
interchangeable.  Flag grids are uint8 tensors compared against
``int(CellType.X)``.
"""

from __future__ import annotations

from enum import IntEnum

__all__ = ["CellType", "KBCType"]


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
