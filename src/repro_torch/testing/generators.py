"""Canonical adversarial input generators for the conformance matrix — a
copy of ``repro.testing.generators`` (numpy only), so that the port's
cases are the reference's byte for byte.

One named generator set, shared by every op contract, so "the engine
survives duplicates / sentinel collisions / NaN / skew / size edges" is
asserted once per (op, engine, mode, dtype) instead of re-invented per test
file. The set encodes every input class that has actually broken (or nearly
broken) an engine in this repo's history:

  * ``random``        — full-range draws (signed ints include negatives);
  * ``dup_heavy``     — a 4-value alphabet, so comparator ties dominate and
                        stability/tie-break handling is load-bearing;
  * ``sentinel``      — values colliding with the padding sentinel
                        (``iinfo.max`` / ``+inf``, plus ``iinfo.min`` /
                        ``-inf``): the class of input that padding
                        can silently lose;
  * ``nan``           — float32 NaN payloads with distinct bit patterns
                        (quiet/signalling, either sign, the all-ones
                        sentinel pattern) plus ``-0.0``/``+0.0`` mixes.
                        The contract is ``jnp.sort``-equivalent total order
                        (see ``kernels/ops.py``): NaNs sink to the tail,
                        the bit-level multiset is conserved exactly, and
                        the output is non-decreasing under the canonical
                        order bits — checked on *every* engine. (Building
                        the first matrix discovered the padded engines
                        losing elements under NaN; the total-order key
                        plane of ``kernels/lex.py`` fixed it, and
                        ``tests/test_conformance`` pins the regression);
  * ``skewed``        — heavy-tailed values / one dominant word length (the
                        capacity-pressure case of the bucket pipeline);
  * ``empty``         — n = 0 (no kernel launch; shape plumbing only);
  * ``singleton``     — n = 1 (maximal padding fraction);
  * ``tile_boundary`` — n = 129: one element past the 128-lane tile, the
                        boundary where the engine cost model switches tiers
                        (oets -> bitonic, 1 -> 2 blocksort blocks) and
                        interpret-mode padding doubles. For word inputs the
                        analogue is byte lengths straddling the 4-byte lane
                        boundaries (3/4/5 and 7/8).

Element generators fill 1-D arrays per dtype; word generators produce the
paper's variable-length words (as ``str``/``bytes``) for the distribute /
bucketize contracts. Sizes default to 96 so every 96/1-element case padded
to one 128-lane tile shares a single interpret-mode kernel compile per
(op, engine, dtype, mode) — the compile budget rule of ``tests/`` (keep
tier-1 widths <= 128; only ``tile_boundary`` deliberately crosses).
"""

from __future__ import annotations

import numpy as np

__all__ = ["ADVERSARIAL", "default_n", "check_mode", "applicable",
           "fill_elements", "make_words", "sorted_run_sizes",
           "kway_run_sizes"]

# the canonical generator set, in documentation order
ADVERSARIAL = ("random", "dup_heavy", "sentinel", "nan", "skewed",
               "empty", "singleton", "tile_boundary")

_DEFAULT_N = 96
_SIZES = {"empty": 0, "singleton": 1, "tile_boundary": 129}


def default_n(gen: str) -> int:
    """Element count of a generator's canonical case."""
    return _SIZES.get(gen, _DEFAULT_N)


def check_mode(gen: str) -> str:
    """'exact' (bit-identical to the oracle) or 'total_order' (bit-level
    multiset conserved AND non-decreasing under the canonical order bits —
    the ``jnp.sort``-equivalent NaN contract, where distinct NaN payloads
    tie so their relative order is unspecified)."""
    return "total_order" if gen == "nan" else "exact"


def applicable(gen: str, dtype) -> bool:
    """Whether a generator draws meaningful data for ``dtype`` (``nan`` is
    float-only; everything else applies everywhere)."""
    if gen == "nan":
        return np.issubdtype(np.dtype(dtype), np.floating)
    return True


def fill_elements(gen: str, rng: np.random.Generator, n: int,
                  dtype) -> np.ndarray:
    """Draw ``n`` elements of ``dtype`` for generator ``gen``."""
    dtype = np.dtype(dtype)
    is_float = np.issubdtype(dtype, np.floating)
    if n == 0:
        return np.zeros(0, dtype)
    if is_float:
        x = rng.normal(scale=10.0, size=n).astype(dtype)
        if gen == "dup_heavy":
            x = rng.choice(np.array([-1.5, -0.0, 0.0, 2.5], dtype), n)
        elif gen == "sentinel":
            x[rng.random(n) < 0.25] = np.inf
            x[rng.random(n) < 0.10] = -np.inf
        elif gen == "nan":
            x[rng.random(n) < 0.15] = np.nan
            # ±0.0 mixes: comparator-equal values with distinct bits
            x[rng.random(n) < 0.10] = dtype.type(-0.0)
            x[rng.random(n) < 0.10] = dtype.type(0.0)
            if dtype.itemsize == 4:
                # distinct NaN bit patterns: quiet/signalling, either sign,
                # and the all-ones padding-sentinel pattern itself
                pats = np.array([0x7FC00001, 0xFFC00000, 0x7F800001,
                                 0xFFFFFFFF], np.uint32).view(np.float32)
                mask = rng.random(n) < 0.10
                x[mask] = pats[rng.integers(0, len(pats), int(mask.sum()))]
        elif gen == "skewed":
            x = np.where(rng.random(n) < 0.9, dtype.type(0.5),
                         (rng.normal(size=n) * 1e6).astype(dtype))
        return x
    info = np.iinfo(dtype)
    if gen == "dup_heavy":
        return rng.integers(0, 4, n).astype(dtype)
    if gen == "sentinel":
        x = rng.integers(0, 100, n).astype(dtype)
        x[rng.random(n) < 0.25] = info.max
        x[rng.random(n) < 0.10] = info.min
        return x
    if gen == "skewed":
        small = rng.integers(0, 2, n)
        big = rng.integers(info.max // 2, info.max, n)
        return np.where(rng.random(n) < 0.9, small, big).astype(dtype)
    # random (and the size edges, which reuse the random fill)
    return rng.integers(info.min, info.max, n, endpoint=True).astype(dtype)


_ALPHABET = list("abcdefghijklmnop")


def _word(rng: np.random.Generator, length: int):
    return "".join(rng.choice(_ALPHABET, length))


def make_words(gen: str, rng: np.random.Generator,
               max_len: int = 8) -> list:
    """Draw the word list for a distribute/bucketize case. Lengths stay
    within ``max_len`` bytes (2 uint32 lanes at the default), the per-length
    bucket count the oracle reconstructs on host."""
    n = default_n(gen)
    if gen == "empty":
        return []
    if gen == "singleton":
        return ["q"]
    if gen == "dup_heavy":
        pool = [_word(rng, l) for l in (1, 3, max_len)]
        return [pool[i] for i in rng.integers(0, len(pool), n)]
    if gen == "sentinel":
        # raw 0xFF bytes pack to lanes equal to the uint32 padding sentinel
        words = [bytes([0xFF]) * int(l)
                 for l in rng.integers(1, max_len + 1, n // 2)]
        words += [_word(rng, int(l))
                  for l in rng.integers(1, max_len + 1, n - n // 2)]
        return [words[i] for i in rng.permutation(len(words))]
    if gen == "skewed":
        # one dominant length: the capacity-pressure / overflow-adjacent case
        lengths = np.where(rng.random(n) < 0.9, max_len - 1,
                           rng.integers(1, max_len + 1, n))
        return [_word(rng, int(l)) for l in lengths]
    if gen == "tile_boundary":
        # byte lengths straddling the 4-byte lane boundaries
        return [_word(rng, l) for l in (3, 4, 5, 7, 8) * 4]
    # random (and nan, which word contracts never register)
    return [_word(rng, int(l)) for l in rng.integers(1, max_len + 1, n)]


def sorted_run_sizes(gen: str) -> tuple[int, int]:
    """(|a|, |b|) for a two-run merge case: asymmetric for ``skewed``, one
    empty run for ``empty``, and straddling the merge block for
    ``tile_boundary``."""
    return {"empty": (0, _DEFAULT_N), "singleton": (1, 1),
            "skewed": (120, 8), "tile_boundary": (129, 100),
            }.get(gen, (_DEFAULT_N, 80))


def kway_run_sizes(gen: str) -> tuple:
    """Per-run sizes for a k-way merge case — always five runs (the
    contract's jitted runner is shape-polymorphic but arity-static), with
    ``empty_run`` interleaving zero-length runs among real ones (the static
    empty-drop path) and every size under the interpret-mode compile
    budget."""
    if gen == "empty_run":
        return (48, 0, 33, 0, 17)
    return (64, 48, 33, 16, 9)
