"""Length-bucketed segmented sort — the paper's core decomposition, the
port's main path (the counterpart of ``repro.core.bucketing``).

"The main idea of the proposed algorithm is distributing the elements of the
input datasets into many additional temporary sub-arrays according to a
number of characters in each word" — buckets are independent, so they sort
in parallel. On the card: pack the words (host), distribute them (kernel
B3) and scatter them into the dense ``(num_buckets, capacity, lanes)``
bucket tensor, sort every bucket in one batched launch (B1, B2, or
blocksort's B2 + B4 — ``kernels.ops.choose_plan`` picks by capacity),
compact the buckets in length order — *shortlex* order, what the paper's
phases 2-3 produce — and pack the shortlex rank keys.

``bucketize_words`` is the host reference the tests compare against.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np
import torch

from . import packing
from .bitonic import bitonic_sort
from .oets import oets_sort_rows
from ..interop import resolve_device, to_device, to_numpy
from ..kernels.keypack import pack_shortlex
from ..kernels.lex import as_bits, from_bits, order_view
from ..kernels.ops import bucketize, distribute, scatter_to_buckets, \
    segmented_sort
from ..runtime.failure import CapacityOverflow

__all__ = ["Buckets", "bucketize_words", "bucketize_packed", "sort_buckets",
           "sorted_packed", "bucketed_sort_words"]

log = logging.getLogger("repro_torch.core")


@dataclass
class Buckets:
    """Dense bucket storage: the paper's 3-D array (bucket, slot, packed
    lanes). Tensors from :func:`bucketize_packed`, numpy arrays from the
    host reference :func:`bucketize_words`."""

    keys: torch.Tensor      # (num_buckets, capacity, lanes) uint32; sentinel padded
    counts: torch.Tensor    # (num_buckets,) int32 — real elements per bucket
    lengths: torch.Tensor   # (num_buckets,) int32 — word length of each bucket
    dropped: int = 0        # elements clipped under on_overflow='clip'


def _packed_keys(keys, device) -> torch.Tensor:
    keys = to_device(keys, device)
    if keys.dim() != 2:
        raise ValueError("keys must be (n, lanes) packed words")
    return keys


def bucketize_packed(keys, capacity: int | None = None,
                     on_overflow: str = "raise", device="cuda") -> Buckets:
    """Distribute packed ``(n, lanes)`` uint32 words (numpy or torch) into
    the dense per-length bucket tensor on ``device``: the distribute kernel
    and one scatter. Bucket ``l`` holds the words of byte length ``l`` in
    arrival order; ``lengths`` is ``arange(4*lanes+1)``.

    ``on_overflow`` — the policy when an explicit ``capacity`` is exceeded:
    'raise' (default; :class:`CapacityOverflow`), 'retry' (one exact-count
    re-scatter) or 'clip' (report the loss in ``Buckets.dropped``)."""
    keys = _packed_keys(keys, device)
    bucket_keys, counts, dropped = bucketize(keys, capacity=capacity,
                                             on_overflow=on_overflow)
    return Buckets(keys=bucket_keys, counts=counts,
                   lengths=torch.arange(bucket_keys.shape[0],
                                        dtype=torch.int32,
                                        device=keys.device),
                   dropped=dropped)


def bucketize_words(words, capacity: int | None = None) -> Buckets:
    """Phase 2 of the paper's pre-processing on the host: distribute words
    into per-length sub-arrays sized by the length histogram (the original
    Python dict loop, a copy of the reference's; numpy arrays out). Length
    is the encoded byte length."""
    by_len: dict[int, list] = {}
    for w in words:
        by_len.setdefault(packing.byte_length(w), []).append(w)
    if not by_len:
        return Buckets(
            keys=np.zeros((0, 0, 1), np.uint32),
            counts=np.zeros((0,), np.int32),
            lengths=np.zeros((0,), np.int32),
        )
    lengths = sorted(by_len)
    cap = capacity or max(len(v) for v in by_len.values())
    lanes = packing.lanes_for_width(max(lengths))
    keys = np.full((len(lengths), cap, lanes), packing.SENTINEL_U32, dtype=np.uint32)
    counts = np.zeros((len(lengths),), np.int32)
    for i, ln in enumerate(lengths):
        bucket = by_len[ln]
        if len(bucket) > cap:
            raise ValueError(f"bucket for length {ln} exceeds capacity {cap}")
        keys[i, : len(bucket)] = packing.pack_words(bucket, width=lanes * 4)
        counts[i] = len(bucket)
    return Buckets(keys=keys, counts=counts, lengths=np.asarray(lengths, np.int32))


def sort_buckets(keys: torch.Tensor, algorithm: str = "pallas",
                 counts: torch.Tensor | None = None,
                 block_size: int | None = None) -> torch.Tensor:
    """Sort every bucket of ``keys`` ``(num_buckets, capacity, lanes)``.

    ``algorithm``:
      * 'pallas' — the name kept from the reference so its counterpart is
        easy to find — the port's hand-written kernel path:
        ``kernels.ops.segmented_sort``, one batched launch over all buckets.
        ``counts`` re-masks the slots past each bucket's count to the
        sentinel; ``block_size`` forces blocksort with that block for every
        bucket (``None`` lets ``choose_plan`` pick the tier by capacity).
      * 'oets' — the paper's parallel bubble sort as a network of torch ops
        (``core.oets``), every bucket at once; the reference's default.
      * 'bitonic' — the bitonic network (``core.bitonic``), bucket by
        bucket.
      * 'xla' — a lex sort of the lanes. XLA's variadic sort has no torch
        counterpart; stable ``torch.sort`` passes over the lanes' order
        keys, from the least significant lane to the most, give the same
        lex order, and every lane is a key, so equal tuples are equal bits
        and the result is the reference's bit for bit.

    The networks and 'xla' trust the tensor's sentinel padding (``counts``
    and ``block_size`` apply to 'pallas' only), and compare the lanes'
    int32 order keys, never a ``torch.uint32`` tensor."""
    if algorithm == "pallas":
        return segmented_sort(keys, counts,
                              algorithm="blocksort" if block_size else "auto",
                              block_size=block_size)
    if algorithm == "oets":
        return oets_sort_rows(keys)
    if algorithm == "bitonic":
        if keys.shape[0] == 0:
            return keys
        return from_bits(torch.stack([as_bits(bitonic_sort(b))
                                      for b in keys]), keys.dtype)
    if algorithm == "xla":
        return _lex_sort_rows(keys)
    raise ValueError(f"unknown algorithm {algorithm!r}")


def _lex_sort_rows(keys: torch.Tensor) -> torch.Tensor:
    """Each row of ``keys`` ``(rows, n, lanes)`` in lex order, lane 0 most
    significant: stable ``torch.sort`` of each lane's order keys, last lane
    first, composing one permutation."""
    bits = as_bits(keys)
    rows, n, lanes = bits.shape
    perm = torch.arange(n, device=bits.device).expand(rows, n).contiguous()
    for lane in reversed(range(lanes)):
        key = order_view(from_bits(bits[..., lane], keys.dtype))
        _, idx = torch.sort(key.gather(1, perm), dim=1, stable=True)
        perm = perm.gather(1, idx)
    return from_bits(bits.gather(1, perm[..., None].expand(rows, n, lanes)),
                     keys.dtype)


def _fused_sort_packed(keys: torch.Tensor, *, capacity: int, algorithm: str,
                       block_size: int | None = None):
    """Distribute, scatter, sort every bucket, compact in shortlex order and
    pack the rank keys. ``keys`` ``(n, lanes)`` uint32 in; out come
    ``(lengths (m,), sorted (m, lanes), counts (num_buckets,), packed)``,
    ``m`` the words that fit ``capacity``, in exact shortlex order."""
    n, lanes = keys.shape
    num_buckets = 4 * lanes + 1
    dest, rank, counts = distribute(keys)
    buckets = scatter_to_buckets(keys, dest, rank, num_buckets=num_buckets,
                                 capacity=capacity)
    counts_c = counts.clamp(max=capacity)
    sorted_keys = sort_buckets(buckets, algorithm, counts=counts_c,
                               block_size=block_size)
    # compaction: the real slots of every bucket, bucket after bucket — the
    # concatenation in length order of the paper's phase 4
    slot = torch.arange(capacity, device=keys.device)
    valid = slot[None, :] < counts_c[:, None]
    flat_keys = as_bits(sorted_keys)[valid].view(torch.uint32)
    blen = torch.arange(num_buckets, dtype=torch.int32, device=keys.device)
    flat_lens = blen[:, None].expand(num_buckets, capacity)[valid]
    packed = pack_shortlex(flat_lens, flat_keys)
    return flat_lens, flat_keys, counts, tuple(packed.lanes)


def sorted_packed(keys, algorithm: str = "pallas",
                  capacity: int | None = None, return_packed: bool = False,
                  on_overflow: str = "raise", device="cuda",
                  block_size: int | None = None):
    """Shortlex-sort packed ``(n, lanes)`` uint32 words (numpy or torch) on
    ``device``. Returns ``(lengths (n,) int32, sorted_keys (n, lanes)
    uint32)`` tensors in exact shortlex order (length-major, then byte-wise);
    with ``return_packed`` a third element carries the packed shortlex
    rank-key lanes.

    ``capacity``: slots per bucket; ``None`` sizes it at the histogram max
    (one extra distribute launch and one sync). ``on_overflow`` — the policy
    for a too-small explicit capacity: 'raise' (default;
    :class:`CapacityOverflow`), 'retry' (run again at the true max) or
    'clip' (drop the overflow; the outputs shrink to the surviving words,
    with a warning). ``algorithm`` and ``block_size``: see
    :func:`sort_buckets`. ``device`` defaults to the card and raises where
    there is none."""
    if on_overflow not in ("raise", "retry", "clip"):
        raise ValueError(f"unknown on_overflow policy {on_overflow!r}")
    keys = _packed_keys(keys, device)
    n = keys.shape[0]
    if n == 0:
        lens = torch.zeros(0, dtype=torch.int32, device=keys.device)
        if not return_packed:
            return lens, keys
        return lens, keys, tuple(pack_shortlex(lens, keys).lanes)
    if capacity is None:
        _, _, counts = distribute(keys)
        capacity = max(1, int(counts.max()))
    flat_lens, flat_keys, counts, packed = _fused_sort_packed(
        keys, capacity=capacity, algorithm=algorithm, block_size=block_size)
    true_max = int(counts.max())
    if true_max > capacity:
        ln = int(torch.argmax(counts))
        dropped = int((counts - capacity).clamp(min=0).sum())
        if on_overflow == "raise":
            raise CapacityOverflow(
                f"bucket for length {ln} exceeds capacity {capacity}",
                capacity, required=true_max, dropped=dropped)
        if on_overflow == "retry":
            log.warning("sorted_packed overflow: capacity %d -> %d "
                        "(lossless retry of the fused program)",
                        capacity, true_max)
            flat_lens, flat_keys, counts, packed = _fused_sort_packed(
                keys, capacity=true_max, algorithm=algorithm,
                block_size=block_size)
        else:
            log.warning("sorted_packed overflow: dropping %d element(s) "
                        "past capacity %d (bucket for length %d needs %d)",
                        dropped, capacity, ln, true_max)
            n = n - dropped
    if not return_packed:
        return flat_lens[:n], flat_keys[:n]
    return flat_lens[:n], flat_keys[:n], tuple(p[:n] for p in packed)


def bucketed_sort_words(words, algorithm: str = "pallas",
                        device="cuda") -> list:
    """The paper's pipeline end to end: pack (host) -> distribute, sort
    every bucket, compact (``device``) -> unpack (host). Returns the words
    in shortlex order. ``algorithm``: see :func:`sort_buckets`; unlike the
    reference, whose default 'oets' runs no kernel, the default here is the
    kernel path."""
    resolve_device(device)
    words = list(words)
    if not words:
        return []
    _, sorted_keys = sorted_packed(packing.pack_words(words),
                                   algorithm=algorithm, device=device)
    return packing.unpack_words(to_numpy(sorted_keys))
