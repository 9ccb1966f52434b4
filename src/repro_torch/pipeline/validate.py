"""Invariant-validation gate for the sort engine — a copy of
``repro.pipeline.validate`` that also takes torch tensors (copied to the
host, bits unchanged, through ``interop.to_numpy``). Cheap host-side checks
that catch silent corruption (a flipped element, a dropped run, a
double-counted bucket) before it propagates into downstream consumers.

The sort pipeline's end-to-end contract decomposes into three invariants,
each checkable far cheaper than a full oracle re-sort:

  * **sortedness** — every run / merge / exchange output is lex
    non-decreasing row to row (one vectorised adjacent compare, O(n·L));
  * **count conservation** — element counts reconcile exactly across every
    boundary: chunk -> run (manifest count), runs -> merge (sum), shard ->
    exchange (the exact-count protocol's matrix);
  * **multiset conservation** — the *content* survives, checked via an
    order-independent digest: each row hashes through a lane-FNV +
    splitmix64 finalizer and the digests **sum mod 2^64**, so the digest of
    a union of runs is the sum of their digests — merge output reconciles
    against its inputs with no re-scan of them. (Probabilistic with
    collision odds ~2^-64 per check; a permutation plus sortedness implies
    a correct sort.) The per-length histogram rides along as a second,
    structure-aware conservation check. Float lanes digest through the
    canonical order-bits view (:func:`order_bits_view`, the numpy mirror of
    ``kernels.lex.to_order_bits``) so engines that compare canonically —
    ``-0.0 == +0.0``, NaN payloads interchangeable — reconcile against
    raw-bit oracles on comparator equality, not bit identity.

Both the sortedness compare and the digest run on the same order-bits view,
so "sorted" and "same multiset" here mean exactly what the engines'
comparator (``kernels/lex.py``) means.

``validate='off'|'cheap'|'full'`` on ``pipeline.ingest.chunked_sort_*`` maps
to: nothing / sortedness +
count + histogram reconciliation / all of that + content digests. All
checks raise :class:`ValidationError` (never assert — the gate is a
production path, tests pin it with seeded corruption).
"""

from __future__ import annotations

import numpy as np
import torch

from ..interop import to_numpy

__all__ = ["ValidationError", "order_bits_view", "multiset_digest",
           "keys_digest", "length_histogram_of", "check_lanes_sorted",
           "check_multiset", "check_run", "check_chunked", "check_sharded"]

_U64 = np.uint64
_FNV_PRIME = _U64(0x100000001B3)
_FNV_OFFSET = _U64(0xCBF29CE484222325)
_MIX1 = _U64(0xBF58476D1CE4E5B9)
_MIX2 = _U64(0x94D049BB133111EB)


def host(x) -> np.ndarray:
    """``x`` — a numpy array, a torch tensor on any device, or a sequence —
    as a numpy array on the host, bits unchanged."""
    return to_numpy(x) if isinstance(x, torch.Tensor) else np.asarray(x)


class ValidationError(RuntimeError):
    """An invariant of the sort pipeline was violated (corruption, loss, or
    duplication detected by the validation gate)."""


def order_bits_view(lane) -> np.ndarray:
    """Numpy mirror of ``kernels.lex.to_order_bits`` for float32 lanes —
    uint32 order bits whose unsigned order is the canonical total order
    (``-0.0`` normalised to ``+0.0``, every NaN above ``+inf``, the
    all-ones pattern strictly maximal). Non-float32 lanes pass through
    unchanged (integers are already totally ordered raw)."""
    a = host(lane)
    if a.dtype != np.dtype(np.float32):
        return a
    top = np.uint32(0x80000000)
    b = np.ascontiguousarray(a).view(np.uint32)
    bn = np.where(a == 0, np.uint32(0), b)  # -0.0 -> +0.0 (NaN compares false)
    flipped = np.where((bn & top) != 0, ~bn, bn | top)
    nan_slot = np.where(b == np.uint32(0xFFFFFFFF),
                        np.uint32(0xFFFFFFFF), np.uint32(0xFFFFFFFE))
    return np.where(np.isnan(a), nan_slot, flipped)


def _as_u64(lane) -> np.ndarray:
    """Canonical-bit view of a 1-D lane as uint64: float32 lanes first map
    through :func:`order_bits_view` (so the digest equates exactly what the
    comparator equates — ``-0.0``/``+0.0``, NaN payloads), integer lanes
    reinterpret raw."""
    a = np.ascontiguousarray(order_bits_view(lane))
    if a.dtype.itemsize == 8:
        return a.view(_U64)
    if a.dtype.itemsize == 4:
        return a.view(np.uint32).astype(_U64)
    if a.dtype.itemsize == 2:
        return a.view(np.uint16).astype(_U64)
    return a.view(np.uint8).astype(_U64)


def _mix(h: np.ndarray) -> np.ndarray:
    # splitmix64 finalizer, vectorised (uint64 arithmetic wraps mod 2^64)
    h = h ^ (h >> _U64(30))
    h = h * _MIX1
    h = h ^ (h >> _U64(27))
    h = h * _MIX2
    return h ^ (h >> _U64(31))


def multiset_digest(lanes) -> int:
    """Order-independent content digest of a tuple of parallel 1-D lanes
    (rows are the multiset members). Additive: the digest of a concatenation
    equals the sum of the digests mod 2^64 — the property the merge
    reconciliation leans on."""
    lanes = [host(l) for l in lanes]
    if not lanes or lanes[0].size == 0:
        return 0
    h = np.full(lanes[0].shape[0], _FNV_OFFSET, _U64)
    for lane in lanes:
        h = (h * _FNV_PRIME) ^ _as_u64(lane)
    return int(np.sum(_mix(h), dtype=_U64))


def keys_digest(keys) -> int:
    """Digest of an (n, lanes) packed word tensor — the per-column lane
    view of :func:`multiset_digest`, shared by pre-sort chunks and sorted
    runs so ingest conservation checks compare like with like."""
    keys = host(keys)
    return multiset_digest([keys[:, l] for l in range(keys.shape[1])])


def length_histogram_of(lengths, num_buckets: int) -> np.ndarray:
    """Dense per-length element counts (bucket id == byte length)."""
    return np.bincount(host(lengths), minlength=num_buckets
                       ).astype(np.int64)


def check_lanes_sorted(lanes, what: str = "output"):
    """Raise unless the row tuples of the parallel 1-D ``lanes`` are lex
    non-decreasing (lane 0 most significant) under the canonical total
    order: float lanes compare by :func:`order_bits_view`, so a NaN out of
    tail position *fails* (a raw compare would silently pass — NaN decides
    neither ``<`` nor ``>``). Error messages report the raw values."""
    lanes = [host(l) for l in lanes]
    n = lanes[0].shape[0]
    if n < 2:
        return
    decided_lt = np.zeros(n - 1, bool)
    decided_gt = np.zeros(n - 1, bool)
    for lane in map(order_bits_view, lanes):
        a, b = lane[:-1], lane[1:]
        undecided = ~(decided_lt | decided_gt)
        decided_gt |= undecided & (a > b)
        decided_lt |= undecided & (a < b)
    if decided_gt.any():
        i = int(np.argmax(decided_gt))
        raise ValidationError(
            f"{what} is not sorted: row {i} > row {i + 1} "
            f"({[l[i] for l in lanes]} > {[l[i + 1] for l in lanes]})")


def check_multiset(in_lanes, out_lanes, what: str = "output"):
    """Raise unless input and output hold the same element multiset
    (count + order-independent digest)."""
    n_in = int(host(in_lanes[0]).shape[0])
    n_out = int(host(out_lanes[0]).shape[0])
    if n_in != n_out:
        raise ValidationError(f"{what}: element count changed "
                              f"{n_in} -> {n_out}")
    d_in, d_out = multiset_digest(in_lanes), multiset_digest(out_lanes)
    if d_in != d_out:
        raise ValidationError(
            f"{what}: content digest mismatch ({d_in:#018x} != "
            f"{d_out:#018x}) — elements were altered, not permuted")


def check_run(run, manifest, mode: str = "cheap"):
    """Reconcile one sorted run against its
    :class:`~repro_torch.pipeline.manifest.RunManifest`: exact count, per-length histogram, sortedness, and (mode
    ``'full'``) the content digest. The gate a resuming job runs before
    trusting a stored run, and the per-chunk gate of
    ``chunked_sort_*(validate=...)``."""
    lengths = host(run.lengths)
    keys = host(run.keys)
    if lengths.shape[0] != manifest.count:
        raise ValidationError(
            f"run {manifest.chunk_id}: count {lengths.shape[0]} != manifest "
            f"count {manifest.count}")
    hist = length_histogram_of(lengths, len(manifest.length_histogram))
    if hist.tolist() != list(manifest.length_histogram):
        raise ValidationError(
            f"run {manifest.chunk_id}: length histogram mismatch "
            f"{hist.tolist()} != {list(manifest.length_histogram)}")
    check_lanes_sorted(
        [lengths] + [keys[:, l] for l in range(keys.shape[1])],
        what=f"run {manifest.chunk_id}")
    if mode == "full" and keys_digest(keys) != manifest.digest:
        raise ValidationError(
            f"run {manifest.chunk_id}: content digest mismatch — run "
            f"elements differ from the manifested multiset")


def check_chunked(runs, manifests, merged, mode: str = "cheap"):
    """The end-to-end gate of ``chunked_sort_*``: every run reconciles
    against its manifest, and the merged output conserves the runs' total
    count, per-length histogram, and (``'full'``) summed content digest —
    catching a dropped run, a double-counted bucket, or a flipped element
    without re-sorting anything."""
    for run, man in zip(runs, manifests):
        check_run(run, man, mode)
    m_lengths = host(merged.lengths)
    m_keys = host(merged.keys)
    total = sum(m.count for m in manifests)
    if m_lengths.shape[0] != total:
        raise ValidationError(
            f"merge lost or duplicated elements: output count "
            f"{m_lengths.shape[0]} != sum of run counts {total}")
    nb = max((len(m.length_histogram) for m in manifests), default=1)
    want_hist = np.zeros(nb, np.int64)
    for m in manifests:
        want_hist[: len(m.length_histogram)] += np.asarray(
            m.length_histogram, np.int64)
    got_hist = length_histogram_of(m_lengths, nb)
    if got_hist.tolist() != want_hist.tolist():
        raise ValidationError(
            f"merge length histogram mismatch: {got_hist.tolist()} != "
            f"{want_hist.tolist()}")
    check_lanes_sorted(
        [m_lengths] + [m_keys[:, l] for l in range(m_keys.shape[1])],
        what="merged output")
    if mode == "full":
        want_digest = sum(m.digest for m in manifests) % (1 << 64)
        got_digest = keys_digest(m_keys)
        if got_digest != want_digest:
            raise ValidationError(
                "merged output content digest mismatch — elements were "
                "altered across the merge")


def check_sharded(run_manifests, shard_manifests, mode: str = "cheap"):
    """Metadata-only gate for a shard-spilled distributed sort: prove the
    shards jointly ARE the sorted union of the ingest runs without
    rescanning any data. Checks (all on manifests):

      * **count conservation** — sum of shard counts == sum of run counts;
      * **histogram conservation** — per-length counts reconcile the same
        way (structure-aware: a swap between length buckets that preserves
        the total still fails);
      * **boundary ordering** — shard *i*'s max key tuple lex<= shard
        *i+1*'s min key tuple (shards are keyed by destination order, so
        their concatenation is globally sorted iff each is internally
        sorted — which :func:`check_run` proves per shard — and the
        boundaries are ordered);
      * (mode ``'full'``) **digest conservation** — shard digests sum mod
        2^64 to the run digests' sum (the additive multiset property: the
        union's digest is the sum, no rescan needed).

    ``shard_manifests`` come ordered by destination. Raises
    :class:`ValidationError` naming the first violated invariant."""
    shard_manifests = list(shard_manifests)
    run_manifests = list(run_manifests)
    total_runs = sum(m.count for m in run_manifests)
    total_shards = sum(m.count for m in shard_manifests)
    if total_shards != total_runs:
        raise ValidationError(
            f"shard combine lost or duplicated elements: shard counts sum "
            f"to {total_shards} != run counts sum {total_runs}")
    nb = max((len(m.length_histogram)
              for m in run_manifests + shard_manifests), default=1)
    want = np.zeros(nb, np.int64)
    got = np.zeros(nb, np.int64)
    for m in run_manifests:
        want[: len(m.length_histogram)] += np.asarray(m.length_histogram,
                                                      np.int64)
    for m in shard_manifests:
        got[: len(m.length_histogram)] += np.asarray(m.length_histogram,
                                                     np.int64)
    if got.tolist() != want.tolist():
        raise ValidationError(
            f"shard length histogram mismatch: {got.tolist()} != "
            f"{want.tolist()}")
    occupied = [m for m in shard_manifests if m.count]
    for a, b in zip(occupied, occupied[1:]):
        if tuple(a.max_key) > tuple(b.min_key):
            raise ValidationError(
                f"shard boundary disorder: shard {a.chunk_id} max key "
                f"{a.max_key} > shard {b.chunk_id} min key {b.min_key}")
    if mode == "full":
        want_digest = sum(m.digest for m in run_manifests) % (1 << 64)
        got_digest = sum(m.digest for m in shard_manifests) % (1 << 64)
        if got_digest != want_digest:
            raise ValidationError(
                "shard content digest mismatch: shard digests sum to "
                f"{got_digest:#018x} != run digests sum "
                f"{want_digest:#018x} — elements were altered across the "
                "combine")
