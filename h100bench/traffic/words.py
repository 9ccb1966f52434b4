"""Word corpora from a seed: the paper's corpus shape as the port's
``data.synthetic.synthetic_words`` draws it (word lengths 1-15 bytes from
an English length distribution, letters a-z with Zipf frequencies), made
in bulk and packed by this module into big-endian uint32 lanes (4 lanes for
15 bytes; the first byte most significant), the layout of the port's
``core.packing.pack_words``.

Every corpus of ``n`` words has the same multiset of lengths, each length's
count its share of ``n`` (largest remainders), in an order drawn from the
seed: seeds change which words and in which order, not how much work a
sort does. The letters come from a table of 65,536 entries, so each
letter's probability is its Zipf share to within 2**-16. The draws run on
``device`` from a ``torch.Generator`` and the corpus comes back as host
numpy arrays, the input a caller hands the sort.
"""

from __future__ import annotations

import numpy as np

# synthetic_words' length distribution (1..15 bytes), before normalising
LENGTH_P = (0.03, 0.17, 0.21, 0.16, 0.11, 0.09, 0.08, 0.06,
            0.04, 0.025, 0.015, 0.01, 0.005, 0.003, 0.002)
ALPHABET = 26
_TABLE = 1 << 16


def length_counts(n: int, max_len: int = 15) -> np.ndarray:
    """Words of each length 1..``max_len`` in a corpus of ``n``: the
    length distribution's shares, rounded by largest remainders."""
    p = np.asarray(LENGTH_P[:max_len], np.float64)
    exact = n * p / p.sum()
    counts = np.floor(exact).astype(np.int64)
    rest = n - int(counts.sum())
    order = np.argsort(-(exact - counts), kind="stable")
    counts[order[:rest]] += 1
    return counts


def letter_table() -> np.ndarray:
    """65,536 letter codes (0..25), each letter's count its Zipf share."""
    p = 1.0 / np.arange(1, ALPHABET + 1)
    p /= p.sum()
    edges = np.round(np.cumsum(p) * _TABLE).astype(np.int64)
    return np.repeat(np.arange(ALPHABET, dtype=np.uint8),
                     np.diff(np.concatenate([[0], edges])))


def lanes_for(max_len: int) -> int:
    return max(1, (max_len + 3) // 4)


def corpus(n: int, seed: int, index: int, max_len: int = 15,
           device="cpu"):
    """Corpus ``index`` of the pool of ``seed``: ``(keys (n, lanes)
    uint32, lengths (n,) int32)`` host arrays."""
    import torch
    gen = torch.Generator(device=device)
    # distinct corpora of one seed, and any seed up to 2**64
    gen.manual_seed((int(seed) * 1_000_003 + index) % (1 << 63))
    lengths = torch.from_numpy(np.repeat(
        np.arange(1, max_len + 1, dtype=np.int32), length_counts(n, max_len)))
    lengths = lengths.to(device)[torch.randperm(n, generator=gen,
                                                device=device)]
    width = 4 * lanes_for(max_len)
    table = torch.from_numpy(letter_table()).to(device)
    draws = torch.randint(0, _TABLE, (n, width), generator=gen,
                          device=device, dtype=torch.int32)
    letters = table[draws] + ord("a")
    pos = torch.arange(width, device=device)
    letters = torch.where(pos[None, :] < lengths[:, None], letters,
                          torch.zeros_like(letters)).to(torch.int64)
    b = letters.reshape(n, width // 4, 4)
    keys = (b[..., 0] << 24) | (b[..., 1] << 16) | (b[..., 2] << 8) | b[..., 3]
    return (keys.cpu().numpy().astype(np.uint32),
            lengths.cpu().numpy().astype(np.int32))


def byte_lengths(keys: np.ndarray) -> np.ndarray:
    """Each packed word's byte length: its last non-zero byte's place."""
    n, lanes = keys.shape
    b = np.stack([(keys >> s) & 0xFF for s in (24, 16, 8, 0)], axis=-1)
    nz = b.reshape(n, 4 * lanes) != 0
    last = np.where(nz.any(1), 4 * lanes - np.argmax(nz[:, ::-1], axis=1), 0)
    return last.astype(np.int32)
