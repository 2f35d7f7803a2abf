"""Flags, enums and device selection."""

from .device import check_device, resolve_device
from .types import CellType, KBCType, widen

__all__ = ["CellType", "KBCType", "widen", "resolve_device", "check_device"]
