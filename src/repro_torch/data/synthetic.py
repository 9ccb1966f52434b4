"""Deterministic synthetic data — a copy of ``repro.data.synthetic``,
making the same numpy draws in the same order, so one seed gives the same
words and the same LM batches in both packages.

``synthetic_words`` approximates the paper's corpus statistics (word
lengths 1..15, Zipf-ish letters); ``TokenStream`` generates LM batches.
"""

from __future__ import annotations

import re

import numpy as np

__all__ = ["synthetic_words", "TokenStream", "clean_text", "words_from_text"]

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


def clean_text(text: str) -> str:
    """Paper pre-processing phase 1: strip special characters."""
    return re.sub(r"[^A-Za-z \n]", " ", text).lower()


def words_from_text(text: str) -> list:
    return [w for w in clean_text(text).split() if w]


class TokenStream:
    """Deterministic infinite stream of ``{"tokens", "labels"}`` LM batches
    of int32 numpy arrays ``(batch, seq)``.

    Labels are next-token shifted; the final position is masked (-1).
    ``shard_index``/``num_shards`` give each host a disjoint stream.
    """

    def __init__(self, vocab_size: int, batch: int, seq: int, seed: int = 0,
                 shard_index: int = 0, num_shards: int = 1):
        self.vocab = vocab_size
        self.batch = batch
        self.seq = seq
        self.seed = seed
        self.shard_index = shard_index
        self.num_shards = num_shards
        self._step = 0

    def __iter__(self):
        return self

    def __next__(self):
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + self._step) * self.num_shards
            + self.shard_index)
        self._step += 1
        toks = rng.integers(0, self.vocab, (self.batch, self.seq + 1),
                            dtype=np.int32)
        labels = toks[:, 1:].copy()
        labels[:, -1] = -1
        return {"tokens": toks[:, :-1], "labels": labels}
