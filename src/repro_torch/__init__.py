"""PyTorch/CUDA port of ``repro``: the paper's length-bucketed word sort on
an NVIDIA H100, through hand-written CUDA kernels.

It imports ``torch`` and numpy, never ``jax`` and nothing of ``repro``.
Layout mirrors the reference: ``core`` (packing, bucketing, blocksort),
``kernels`` (the key plane, the six kernels and their plain versions, the
ops), ``pipeline`` (the chunked sort and its run merge), ``configs``,
``data``, ``runtime``, plus ``interop`` for moving arrays between the two
packages. Kernels build on their first CUDA launch
(``kernels/_build.py``); importing the package builds nothing.
"""

from .core.bucketing import (Buckets, bucketed_sort_words, bucketize_packed,
                             sorted_packed)
from .interop import to_device, to_numpy
from .pipeline import chunked_sort_packed, chunked_sort_words, merge_runs

__all__ = ["Buckets", "bucketed_sort_words", "bucketize_packed",
           "sorted_packed", "chunked_sort_packed", "chunked_sort_words",
           "merge_runs", "to_device", "to_numpy"]
