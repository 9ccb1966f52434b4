"""Runtime failure types of the port."""

from .failure import CapacityOverflow

__all__ = ["CapacityOverflow"]
