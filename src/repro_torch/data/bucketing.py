"""Length-bucketed batching — the paper's decomposition as a data-pipeline
and serving-admission stage; a copy of ``repro.data.bucketing`` (numpy
only).

The paper buckets words by character count so equal-length items process
together; an LM system buckets *sequences* by token count so batch padding
is minimised. ``plan_buckets`` chooses bounds from a length histogram (the
paper: "sizes decided by the number of elements with the same length"); the
batcher groups items and emits dense padded batches. The statistic is the
port's ``pipeline.histogram``, which the serving admission shares.
"""

from __future__ import annotations

import bisect
from typing import List, Sequence

import numpy as np

from ..pipeline.histogram import quantile_bounds

__all__ = ["plan_buckets", "LengthBucketedBatcher", "padding_waste"]


def plan_buckets(lengths: Sequence[int], n_buckets: int = 8) -> List[int]:
    """Quantile-based bucket upper bounds covering the observed lengths.
    Empty input plans no buckets (``[]``)."""
    return quantile_bounds(lengths, n_buckets)


def padding_waste(lengths: Sequence[int], batch_seq: int) -> float:
    """Fraction of padded tokens when batching to a fixed length."""
    ls = np.asarray(lengths)
    return float(1.0 - ls.sum() / (len(ls) * batch_seq))


class LengthBucketedBatcher:
    """Groups variable-length items ``(id, sequence)`` into per-bucket
    batches. A batch is emitted when a bucket fills to ``batch_size`` (or on
    :meth:`flush`), padded to the bucket's bound, not the global max."""

    def __init__(self, bounds: Sequence[int], batch_size: int,
                 pad_value: int = 0):
        self.bounds = list(bounds)
        if any(lo > hi for lo, hi in zip(self.bounds, self.bounds[1:])):
            raise ValueError(
                f"bucket bounds must be ascending, got {self.bounds}")
        self.batch_size = batch_size
        self.pad_value = pad_value
        self._pending: dict[int, list] = {i: [] for i in range(len(self.bounds))}

    def _bucket_of(self, length: int) -> int:
        # pipeline.histogram.assign_buckets' rule, one item at a time:
        # lengths past the largest bound are rejected
        i = bisect.bisect_left(self.bounds, length)
        if i == len(self.bounds):
            raise ValueError(
                f"length {length} exceeds largest bucket {self.bounds[-1]}")
        return i

    def add(self, item_id, seq) -> list:
        """Add one item; returns zero or more ready batches."""
        b = self._bucket_of(len(seq))
        self._pending[b].append((item_id, seq))
        if len(self._pending[b]) >= self.batch_size:
            return [self._emit(b)]
        return []

    def flush(self) -> list:
        return [self._emit(b) for b in list(self._pending) if self._pending[b]]

    def _emit(self, b: int):
        items = self._pending[b]
        self._pending[b] = []
        bound = self.bounds[b]
        ids = [i for i, _ in items]
        arr = np.full((len(items), bound), self.pad_value, dtype=np.int32)
        lens = np.zeros((len(items),), np.int32)
        for r, (_, seq) in enumerate(items):
            arr[r, : len(seq)] = np.asarray(seq, np.int32)
            lens[r] = len(seq)
        return {"ids": ids, "tokens": arr, "lengths": lens,
                "bucket_bound": bound}
