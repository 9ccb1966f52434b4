"""Shared length-histogram / bucket-assignment utility — the paper's phase-1
count pass, implemented once; a copy of ``repro.pipeline.histogram``
(numpy only, so the port keeps its own).

``data.bucketing``'s quantile bucket bounds and ``serve.scheduler``'s
admission consume it in the reference (ROADMAP A12 ports those callers);
the device-side rendering of the same count is the histogram output of
``kernels/distribute_kernel.py``.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

__all__ = ["length_histogram", "assign_buckets", "bucket_of",
           "quantile_bounds"]


def length_histogram(lengths: Sequence[int],
                     num_bins: int | None = None) -> np.ndarray:
    """Counts per exact length: ``out[l]`` = number of items of length
    ``l``. ``num_bins`` pins the output size (default: max length + 1);
    empty input gives an all-zero (or empty) histogram."""
    ls = np.asarray(lengths, dtype=np.int64)
    if num_bins is None:
        num_bins = int(ls.max()) + 1 if ls.size else 0
    return np.bincount(ls, minlength=num_bins)[:num_bins] if num_bins \
        else np.zeros((0,), np.int64)


def assign_buckets(lengths: Sequence[int], bounds: Sequence[int],
                   clamp: bool = True) -> np.ndarray:
    """Vectorized bucket assignment: item of length ``l`` goes to the first
    bucket whose upper bound is ``>= l``. Lengths beyond the last bound land
    in the last bucket when ``clamp`` (the scheduler's admission contract)
    and raise ``ValueError`` otherwise (the batcher's). ``bounds`` must
    ascend (``quantile_bounds`` output is) — the searchsorted assignment is
    meaningless on unsorted bounds, so they are rejected rather than
    silently mis-bucketed."""
    ls = np.asarray(lengths, dtype=np.int64)
    if len(bounds) == 0:
        if ls.size:
            raise ValueError("no buckets planned (empty bounds)")
        return np.zeros((0,), np.int64)
    barr = np.asarray(bounds, dtype=np.int64)
    if (np.diff(barr) < 0).any():
        raise ValueError(f"bucket bounds must be ascending, got {list(bounds)}")
    idx = np.searchsorted(barr, ls, side="left")
    over = idx >= len(bounds)
    if over.any():
        if not clamp:
            bad = int(ls[over][0])
            raise ValueError(
                f"length {bad} exceeds largest bucket {bounds[-1]}")
        idx = np.minimum(idx, len(bounds) - 1)
    return idx.astype(np.int64)


def bucket_of(length: int, bounds: Sequence[int], clamp: bool = True) -> int:
    """Scalar view of :func:`assign_buckets`."""
    return int(assign_buckets([length], bounds, clamp=clamp)[0])


def quantile_bounds(lengths: Sequence[int], n_buckets: int = 8) -> List[int]:
    """Quantile-based bucket upper bounds covering the observed lengths
    (the paper: sub-array sizes "decided by the number of elements with the
    same length"). Empty input plans no buckets — ``[]``."""
    ls = np.sort(np.asarray(lengths))
    if ls.size == 0:
        return []
    qs = np.linspace(0, 1, n_buckets + 1)[1:]
    bounds = sorted(set(
        int(ls[min(int(q * (len(ls) - 1)), len(ls) - 1)]) for q in qs))
    if bounds[-1] < ls[-1]:
        bounds.append(int(ls[-1]))
    return bounds
