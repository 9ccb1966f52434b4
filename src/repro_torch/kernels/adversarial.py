"""Adversarial inputs that hold the kernels to their plain versions, shared
by the card's tests (``tests/test_torch_gpu.py``) and ``chip_smoke.py``:
lane bits that collide with a code's padding value, repeat a few values or
carry float NaN payloads and ±0.0 (B4's block sweep), and unsorted,
duplicated splitter lists with keys at and beside them (B7's splitter
sweep). numpy arrays, made from the seed; nothing here touches a device.
"""

from __future__ import annotations

import numpy as np

from . import lex

__all__ = ["FILLS", "lane_bits", "partition_case"]

FILLS = ("sentinel", "dup_heavy", "nan")
_INFO32 = np.iinfo(np.int32)


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
