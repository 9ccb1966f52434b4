"""Adversarial inputs that hold the kernels to their plain versions, shared
by the card's tests (``tests/test_torch_gpu.py``) and ``chip_smoke.py``:
lane bits that collide with a code's padding value, repeat a few values or
carry float NaN payloads and ±0.0 (B4's block sweep), and unsorted,
duplicated splitter lists with keys at and beside them (B7's splitter
sweep), and packed words whose byte lengths pile up or alternate (B3's
sweep), and pairs of sorted runs at the co-rank edges of a two-run merge
(B5's sweep), and k sorted runs of ragged lengths, empty and
one-element runs among them (the k-way split's and B6's sweep). numpy
arrays, made from the seed; nothing here touches a device.
"""

from __future__ import annotations

import numpy as np

from . import lex

__all__ = ["FILLS", "WORD_FILLS", "MERGE_EDGES", "KWAY_SWEEP", "lane_bits",
           "partition_case", "packed_words", "fill_codes", "merge_case",
           "kway_case"]

FILLS = ("sentinel", "dup_heavy", "nan")
WORD_FILLS = ("nul_ff", "one_length", "warp_alternate")
# pairs of runs a two-run merge meets: sizes (na, nb), and how b's values
# relate to a's
MERGE_EDGES = {
    "random": (1000, 777),        # na + nb not a multiple of any block
    "a_empty": (0, 300),
    "b_empty": (300, 0),
    "a_single": (1, 500),
    "b_single": (500, 1),
    "equal": (400, 400),          # b holds a's tuples: every tie goes to a
    "a_below": (600, 400),        # every a at or below every b
    "a_above": (400, 600),        # every b at or below every a
    "whole_blocks": (300, 212),   # 512: the last boundary lands on the end
}
# run counts of the k-way sweep: a pair, an odd count, DS2's 57 runs, the
# 1M sort's 64, past a power of two, and the most one launch takes
KWAY_SWEEP = (2, 3, 8, 57, 64, 257, 1024)
_INFO32 = np.iinfo(np.int32)
_VIEWS = {lex.U32: np.uint32, lex.I32: np.int32, lex.F32: np.float32}


def lane_bits(rng: np.random.Generator, shape, code: int,
              fill: str) -> np.ndarray:
    """int32 bits of ``shape`` for lanes of ``code``: 'sentinel' (a fifth of
    them the code's padding value, and for I32 also INT32_MIN), 'dup_heavy'
    (four values) or 'nan' (float32 NaN payloads, ±0.0 and ±inf, as bits of
    any code)."""
    if fill == "dup_heavy":
        v = rng.integers(0, 4, shape)
        if code == lex.F32:
            return np.array([0.0, -0.0, 1.5, np.nan], np.float32)[v].view(
                np.int32)
        return v.astype(np.int32)
    if fill == "nan":
        f = rng.normal(size=shape).astype(np.float32)
        pick = rng.random(shape)
        f[pick < 0.15] = 0.0
        f[(pick >= 0.15) & (pick < 0.3)] = -0.0
        f[(pick >= 0.3) & (pick < 0.4)] = np.inf
        f[(pick >= 0.4) & (pick < 0.45)] = -np.inf
        pats = np.array([0x7FC00000, 0x7FC00001, 0xFFC00000, 0x7F800001,
                         0xFFFFFFFF], np.uint32).view(np.float32)
        nan = pick >= 0.8
        f[nan] = pats[rng.integers(0, len(pats), int(nan.sum()))]
        return f.view(np.int32)
    if fill != "sentinel":
        raise ValueError(f"lane_bits: unknown fill {fill!r}")
    v = rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)
    pad = {lex.U32: 0xFFFFFFFF, lex.I32: 0x7FFFFFFF, lex.F32: 0xFFFFFFFF}
    v[rng.random(shape) < 0.2] = pad[code]
    if code == lex.I32:
        v[rng.random(shape) < 0.05] = 0x80000000
    return v.view(np.int32)


def partition_case(n_spl: int, cols: int, seed: int):
    """``(keys, splitters)`` as int32 arrays: ``n_spl`` splitters in
    [-5000, 5000), unsorted, a quarter of them repeating the first and both
    int32 extremes among them (from four splitters up), and three rows of
    ``cols`` keys of which a third equal a splitter and a tenth sit at
    INT32_MIN or INT32_MAX."""
    rng = np.random.default_rng([n_spl, cols, seed])
    spl = rng.integers(-5000, 5000, n_spl).astype(np.int32)
    if n_spl >= 4:
        spl[rng.integers(0, n_spl, n_spl // 4)] = spl[0]
        spl[1], spl[2] = _INFO32.min, _INFO32.max
    keys = rng.integers(-6000, 6000, (3, cols)).astype(np.int32)
    if n_spl:
        eq = rng.random(keys.shape) < 0.33
        keys[eq] = spl[rng.integers(0, n_spl, int(eq.sum()))]
    ext = rng.random(keys.shape)
    keys[ext < 0.05] = _INFO32.min
    keys[ext > 0.95] = _INFO32.max
    return keys, rng.permutation(spl)


def packed_words(rng: np.random.Generator, n: int, lanes: int,
                 fill: str) -> np.ndarray:
    """``(n, lanes)`` int32 bits of packed words (big-endian bytes, as
    ``core/packing.py`` packs them): 'nul_ff' (random bytes, a third of
    them NUL and a fifth 0xFF, so lengths spread and interior NULs count),
    'one_length' (every word of one length: one bucket takes all) or
    'warp_alternate' (the length switches between 1 and ``4 * lanes``
    every 32 words, from one warp to the next)."""
    width = 4 * lanes
    b = rng.integers(1, 256, (n, width), dtype=np.uint8)
    col = np.arange(width)[None, :]
    if fill == "nul_ff":
        b[col >= rng.integers(0, width + 1, n)[:, None]] = 0
        pick = rng.random((n, width))
        b[pick < 0.33] = 0
        b[pick > 0.8] = 0xFF
    else:
        if fill == "one_length":
            length = np.full(n, int(rng.integers(1, width + 1)))
        elif fill == "warp_alternate":
            length = np.where(np.arange(n) // 32 % 2, width, 1)
        else:
            raise ValueError(f"packed_words: unknown fill {fill!r}")
        b[col >= length[:, None]] = 0
        # NULs before the last byte leave the length as it is
        b[(rng.random((n, width)) < 0.2) & (col < length[:, None] - 1)] = 0
    return np.ascontiguousarray(b).view(">u4").astype(np.uint32).view(
        np.int32).reshape(n, lanes)


def fill_codes(fill: str, n: int) -> list:
    """The lane codes a fill is swept with: 'sentinel' alternates uint32
    and int32 lanes (each padding value, and INT32_MIN), 'dup_heavy' takes
    uint32 lanes, 'nan' float32 lanes."""
    if fill == "sentinel":
        return [(lex.U32, lex.I32)[a % 2] for a in range(n)]
    return [lex.F32 if fill == "nan" else lex.U32] * n


def _order_keys(bits: np.ndarray, code: int) -> np.ndarray:
    """The canonical order bits of int32 ``bits`` of ``code`` as uint32
    (``lex.to_order_bits``): float NaNs above +inf and equal but for the
    all-ones padding NaN, which is highest; -0.0 == +0.0."""
    b = bits.view(np.uint32)
    if code == lex.U32:
        return b
    if code == lex.I32:
        return b ^ np.uint32(0x80000000)
    mag = b & np.uint32(0x7FFFFFFF)
    b = np.where(mag == 0, np.uint32(0), b)
    key = np.where(b >> 31 == 1, ~b, b | np.uint32(0x80000000))
    nan = np.where(b == 0xFFFFFFFF, np.uint32(0xFFFFFFFF),
                   np.uint32(0xFFFFFFFE))
    return np.where(mag > 0x7F800000, nan, key).astype(np.uint32)


def merge_case(rng: np.random.Generator, n_cmp: int, fill: str,
               edge: str):
    """``(a, b, codes)``: two runs of the co-rank ``edge``
    (:data:`MERGE_EDGES`), each a list of int32 bit arrays — ``n_cmp``
    compare lanes of ``fill`` (codes :func:`fill_codes`), then two payload
    lanes, the run (0 or 1) and the element's index in it — sorted by the
    compare lanes alone (the payload in run order among ties)."""
    codes = fill_codes(fill, n_cmp)
    na, nb = MERGE_EDGES[edge]
    pool = np.stack([lane_bits(rng, (na + nb,), c, fill) for c in codes])
    keys = np.stack([_order_keys(p, c) for p, c in zip(pool, codes)])

    def in_order(idx):
        return idx[np.lexsort(keys[::-1, idx])] if len(idx) else idx

    if edge == "equal":
        ia = in_order(np.arange(na))
        ib = ia
    elif edge in ("a_below", "a_above"):
        low = in_order(np.arange(na + nb))
        lo_n = na if edge == "a_below" else nb
        ia, ib = low[:lo_n], low[lo_n:]
        if edge == "a_above":
            ia, ib = ib, ia
    else:
        ia, ib = in_order(np.arange(na)), in_order(np.arange(na, na + nb))

    def run(idx, which):
        return [np.ascontiguousarray(l[idx]) for l in pool] + [
            np.full(len(idx), which, np.int32),
            np.arange(len(idx), dtype=np.int32)]

    return run(ia, 0), run(ib, 1), codes


def kway_case(rng: np.random.Generator, n_cmp: int, fill: str, k: int,
              max_len: int):
    """``(runs, codes)``: ``k`` runs of 0 to ``max_len`` elements (a fifth of
    them empty and a fifth of one element), each a list of arrays —
    ``n_cmp`` compare lanes of ``fill`` (codes :func:`fill_codes`), each
    viewed as its code's type, then two int32 payload lanes, the run and
    the element's index in it — sorted by the compare lanes alone."""
    codes = fill_codes(fill, n_cmp)
    sizes = rng.integers(0, max_len + 1, k)
    pick = rng.random(k)
    sizes[pick < 0.2] = 0
    sizes[(pick >= 0.2) & (pick < 0.4)] = 1
    runs = []
    for r, n in enumerate(sizes):
        lanes = np.stack([lane_bits(rng, (int(n),), c, fill) for c in codes])
        keys = np.stack([_order_keys(x, c) for x, c in zip(lanes, codes)])
        order = np.lexsort(keys[::-1]) if n else np.zeros(0, np.int64)
        runs.append([x[order].view(_VIEWS[c]) for x, c in zip(lanes, codes)]
                    + [np.full(int(n), r, np.int32),
                       np.arange(int(n), dtype=np.int32)])
    return runs, codes
