"""Deterministic synthetic words — a copy of ``repro.data.synthetic``'s
``synthetic_words``, making the same numpy draws in the same order, so one
seed gives the same words in both packages."""

from __future__ import annotations

import numpy as np

__all__ = ["synthetic_words"]

_ALPHA = np.array(list("abcdefghijklmnopqrstuvwxyz"))
# empirical English word-length distribution (1..15+), renormalized
_LEN_P = np.array([0.03, 0.17, 0.21, 0.16, 0.11, 0.09, 0.08, 0.06,
                   0.04, 0.025, 0.015, 0.01, 0.005, 0.003, 0.002])


def synthetic_words(n: int, seed: int = 0, max_len: int = 15) -> list:
    """n pseudo-English words with realistic length distribution."""
    rng = np.random.default_rng(seed)
    p = _LEN_P[:max_len] / _LEN_P[:max_len].sum()
    lengths = rng.choice(np.arange(1, max_len + 1), size=n, p=p)
    # letter frequencies roughly english-like via Zipf over the alphabet
    letter_p = 1.0 / np.arange(1, 27)
    letter_p /= letter_p.sum()
    out = []
    for ln in lengths:
        out.append("".join(rng.choice(_ALPHA, size=ln, p=letter_p)))
    return out
