"""The plain reference of the word sort: shortlex order (byte length
first, then the bytes, i.e. the packed uint32 lanes in order) by numpy's
stable ``lexsort``, and the packed shortlex rank keys of a sorted run
computed from their definition: the fields ``(length, lane 0, lane 1,
...)`` concatenated big-endian, the length in ``bit_length(4 * lanes)``
bits and each lane in 32, cut to the first 64 bits and split into
``(hi, lo)`` uint32 halves (one lane where the fields fit 32 bits).

Nothing here imports the port. ``control_sort`` is the check's control:
the same sort with each key lane compared as float32, the precision below
the configuration's exact uint32 compare, which mis-orders words that
differ only past a lane's first 24 significant bits.
"""

from __future__ import annotations

import numpy as np


def _order(lengths, keys, lane_dtype=None) -> np.ndarray:
    lanes = [keys[:, i] if lane_dtype is None else
             keys[:, i].astype(lane_dtype) for i in range(keys.shape[1])]
    return np.lexsort(lanes[::-1] + [lengths])


def sort(lengths: np.ndarray, keys: np.ndarray):
    """``(lengths, keys)`` of the words in shortlex order."""
    o = _order(lengths, keys)
    return lengths[o], keys[o]


def control_sort(lengths: np.ndarray, keys: np.ndarray):
    """:func:`sort` with the key lanes compared as float32."""
    o = _order(lengths, keys, np.float32)
    return lengths[o], keys[o]


def pack(lengths: np.ndarray, keys: np.ndarray) -> tuple:
    """The packed shortlex rank keys of ``(lengths, keys)``, row by row."""
    lanes = keys.shape[1]
    fields = [(lengths.astype(np.uint64), int(4 * lanes).bit_length())]
    fields += [(keys[:, i].astype(np.uint64), 32) for i in range(lanes)]
    budget = 64
    acc = np.zeros(len(lengths), np.uint64)
    for value, bits in fields:
        take = min(bits, budget)
        if take == 0:
            break
        acc = (acc << np.uint64(take)) | (value >> np.uint64(bits - take))
        budget -= take
    used = 64 - budget
    if used <= 32:
        return (acc.astype(np.uint32),)
    acc = acc << np.uint64(budget)          # left-align the 64 bits
    return ((acc >> np.uint64(32)).astype(np.uint32),
            (acc & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def rows_off(want_lengths, want_keys, lengths, keys) -> int:
    """Rows of ``(lengths, keys)`` that differ from the reference's, and
    every row missing or extra."""
    n = min(len(want_lengths), len(lengths))
    bad = (np.asarray(lengths[:n]) != want_lengths[:n]) | \
        (np.asarray(keys[:n]) != want_keys[:n]).any(axis=1)
    return int(bad.sum()) + abs(len(want_lengths) - len(lengths))


def packed_off(want: tuple, got: tuple) -> int:
    """Rows whose packed rank keys differ, and every row missing or
    extra; a run with another number of packed lanes is wrong in every
    row."""
    if got is None or len(got) != len(want):
        return len(want[0])
    n = min(len(want[0]), len(got[0]))
    bad = np.zeros(n, bool)
    for w, g in zip(want, got):
        bad |= np.asarray(g[:n]) != w[:n]
    return int(bad.sum()) + abs(len(want[0]) - len(got[0]))
