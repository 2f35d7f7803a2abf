"""Flags, enums and device selection."""

from .device import check_device, resolve_device
from .types import CellType, KBCType

__all__ = ["CellType", "KBCType", "resolve_device", "check_device"]
