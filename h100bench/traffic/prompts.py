"""Prompts from a seed for the serving cells: waves of requests whose
prompt lengths are the quantiles of a lognormal (median ``prompt_median``,
sigma ``prompt_sigma``, clipped to ``[prompt_min, prompt_max]``) at
``(i + 0.5) / wave``, in an order drawn from the seed, and whose token ids
are uniform over the vocabulary. Every wave of every seed holds the same
lengths, so a seed changes the tokens, the routing and the order, not the
amount of work."""

from __future__ import annotations

import math
from statistics import NormalDist

import numpy as np


def lengths(mix: dict) -> np.ndarray:
    n = mix["wave"]
    z = [NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)]
    ls = [round(math.exp(math.log(mix["prompt_median"])
                         + mix["prompt_sigma"] * zi)) for zi in z]
    return np.clip(np.array(ls, np.int64), mix["prompt_min"],
                   mix["prompt_max"])


def wave(mix: dict, seed: int, index: int, vocab: int):
    """Wave ``index`` of ``seed``: ``[(request id, prompt token list)]``,
    the ids ``(index, i)``."""
    rng = np.random.default_rng([int(seed) % (1 << 63), 11, index])
    ls = rng.permutation(lengths(mix))
    toks = rng.integers(0, vocab, size=int(ls.sum()))
    cuts = np.cumsum(ls)[:-1]
    return [((index, i), p.tolist())
            for i, p in enumerate(np.split(toks, cuts))]
