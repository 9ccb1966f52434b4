"""Workload configurations of the port (the paper's two datasets)."""

from .paper_sort import CONFIG, DS1, DS2, SortConfig

__all__ = ["SortConfig", "DS1", "DS2", "CONFIG"]
