"""Chunked ingest: sort inputs of any length in fixed-size chunks through
the main path, then merge the sorted runs — the counterpart of
``repro.pipeline.ingest``.

Each chunk of packed words runs ``core.bucketing.sorted_packed`` on the
device (distribute, bucket sort, shortlex compaction, rank keys) into a
:class:`SortedRun`; the runs combine through ``pipeline.merge.merge_runs``
(the k-way kernel, or the tournament of merge-path kernels). The device
memory of one chunk's sort is bounded by the chunk size.

Runs carry an explicit length lane, so the merge key is the shortlex tuple
``(length, lane_0, ..., lane_L-1)``: packed keys alone order byte-wise
("aa" < "z"), not shortlex ("z" < "aa").

Both front-ends overlap host work with the device through a one-worker
double buffer (:func:`_prefetch_map`): the worker packs chunk ``i+1`` (the
words front-end) and stages it while chunk ``i`` sorts. Staging
(:func:`_stage_chunk`) copies the chunk into pinned host memory and starts
a ``non_blocking`` upload on a side CUDA stream; the sorting stream waits on
the upload's event and ``record_stream`` keeps the tensor alive there.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..core import packing
from ..core.bucketing import sorted_packed
from ..interop import resolve_device, to_device
from ..kernels.keypack import (cmp_from_packed, packed_cmp_lanes,
                               shortlex_max_values)
from .manifest import RunManifest
from .merge import merge_runs
from .validate import check_chunked, host

__all__ = ["DEFAULT_CHUNK", "SortedRun", "sorted_run",
           "chunked_sort_packed", "chunked_sort_words"]

_VALIDATE_MODES = ("off", "cheap", "full")

# Chunk size balancing launch count against the per-chunk bucket tensor
# (num_buckets * capacity * lanes uint32 slots; capacity <= chunk).
DEFAULT_CHUNK = 4096


@dataclass
class SortedRun:
    """One shortlex-sorted run: ``lengths[i]`` is the byte length of the
    word packed in ``keys[i]``; rows ascend by ``(length, bytes)``.
    ``packed`` optionally holds the 1-2 uint32 rank-key lanes of the
    shortlex tuples, which the per-chunk sort emits."""

    lengths: torch.Tensor   # (m,) int32
    keys: torch.Tensor      # (m, lanes) uint32
    packed: Optional[Tuple] = None

    def lanes(self):
        """The run as a merge-ready lex tuple (length lane first)."""
        return (self.lengths,
                *(self.keys[:, l] for l in range(self.keys.shape[1])))

    def cmp_lanes(self):
        """The minimal compare-lane list for ranking this run in a merge:
        the precomputed rank keys and keypack's tie-break suffix, or a
        fresh packing when the run has none."""
        lanes = list(self.lanes())
        mv = shortlex_max_values(self.keys.shape[1])
        if self.packed is None:
            return packed_cmp_lanes(lanes, mv)
        return cmp_from_packed(list(self.packed), lanes, mv)

    @classmethod
    def from_lanes(cls, lanes):
        return cls(lengths=lanes[0], keys=torch.stack(list(lanes[1:]), dim=1))


def sorted_run(keys, algorithm: str = "pallas", capacity: int | None = None,
               on_overflow: str = "raise", device="cuda") -> SortedRun:
    """Sort one packed ``(n, lanes)`` chunk on ``device`` into a
    :class:`SortedRun`, rank keys included. ``on_overflow`` forwards to
    ``core.bucketing.sorted_packed`` ('raise' | 'retry' | 'clip')."""
    lengths, sorted_keys, packed = sorted_packed(
        keys, algorithm=algorithm, capacity=capacity, return_packed=True,
        on_overflow=on_overflow, device=device)
    return SortedRun(lengths=lengths, keys=sorted_keys, packed=packed)


def _check_args(validate: str, chunk_size: int, store, supervisor):
    if validate not in _VALIDATE_MODES:
        raise ValueError(f"validate must be one of {_VALIDATE_MODES}")
    if chunk_size < 1:
        raise ValueError("chunk_size must be >= 1")
    if store is not None:
        raise NotImplementedError("the resumable run store is not ported "
                                  "yet (ROADMAP A8)")
    if supervisor is not None:
        raise NotImplementedError("the sort supervisor is not ported yet "
                                  "(ROADMAP A10)")


def _stage_chunk(chunk: np.ndarray, device: torch.device, stream):
    """Start the upload of one packed chunk: a pinned host copy and a
    ``non_blocking`` copy to ``device`` on the side ``stream``. Returns
    ``(tensor, event)`` for :func:`_take_chunk`; on the CPU, the chunk as a
    tensor and no event."""
    bits = torch.from_numpy(
        np.ascontiguousarray(chunk, dtype=np.uint32).view(np.int32))
    if device.type != "cuda":
        return bits, None
    with torch.cuda.stream(stream):
        on_device = bits.pin_memory().to(device, non_blocking=True)
        uploaded = torch.cuda.Event()
        uploaded.record(stream)
    return on_device, uploaded


def _take_chunk(staged, device: torch.device) -> torch.Tensor:
    """The staged chunk as a uint32 tensor usable on the current stream."""
    bits, uploaded = staged
    if uploaded is not None:
        current = torch.cuda.current_stream(device)
        current.wait_event(uploaded)
        bits.record_stream(current)
    return bits.view(torch.uint32)


def _prefetch_map(fn, items):
    """Yield ``fn(item)`` in order, computing the *next* call on a worker
    thread while the consumer processes the current result."""
    items = list(items)
    if not items:
        return
    with ThreadPoolExecutor(max_workers=1) as ex:
        fut = ex.submit(fn, items[0])
        for nxt in items[1:]:
            cur = fut.result()
            fut = ex.submit(fn, nxt)
            yield cur
        yield fut.result()


def _sort_chunks(chunks, *, algorithm, capacity, on_overflow, validate,
                 merge_engine, device) -> SortedRun:
    """Sort every chunk (device tensors) into a run, merge the runs, and
    run the validation gate."""
    runs, manifests = [], []
    for ci, keys in enumerate(chunks):
        cap = capacity if capacity is not None else int(keys.shape[0])
        run = sorted_run(keys, algorithm=algorithm, capacity=cap,
                         on_overflow=on_overflow, device=device)
        runs.append(run)
        if validate != "off":
            manifests.append(RunManifest.from_run(run, ci))
    merged = runs[0]
    if len(runs) > 1:
        merged = SortedRun.from_lanes(merge_runs(
            [r.lanes() for r in runs], engine=merge_engine,
            cmp_runs=[r.cmp_lanes() for r in runs],
            manifests=manifests or None))
    if validate != "off":
        check_chunked(runs, manifests, merged, mode=validate)
    return merged


def chunked_sort_packed(keys, chunk_size: int = DEFAULT_CHUNK,
                        algorithm: str = "pallas",
                        capacity: int | None = None,
                        store=None, supervisor=None,
                        validate: str = "off",
                        on_overflow: str = "raise",
                        merge_engine: str = "auto",
                        device="cuda") -> SortedRun:
    """Shortlex-sort packed ``(n, lanes)`` uint32 words of any length
    (numpy or torch) on ``device``, ``chunk_size`` rows per sort, then merge
    the sorted runs. Returns the full-input :class:`SortedRun`.

    ``capacity`` (slots per bucket of each chunk's sort) defaults to the
    chunk's row count — the worst case, every word one length.
    ``validate``: 'off' | 'cheap' | 'full' (``validate.check_chunked``:
    per-run manifests, then the merge's count, histogram and sortedness;
    'full' adds content digests). ``on_overflow``: the bucket-overflow
    policy of each chunk's sort. ``merge_engine``: 'auto'/'kway' (one
    k-way pass), 'kway_kernel' (the k-way kernel forced) or 'tournament'
    (pairwise rounds) — see ``pipeline.merge.merge_runs``. ``store`` and
    ``supervisor`` keep the reference's signature; the run store (ROADMAP
    A8) and the supervisor (A10) are not ported yet and raise.

    Host (numpy) input stays on the host until its chunk is staged, chunk
    ``i+1``'s upload overlapping chunk ``i``'s sort."""
    _check_args(validate, chunk_size, store, supervisor)
    device = resolve_device(device)
    if isinstance(keys, torch.Tensor) and keys.device.type == device.type:
        n = keys.shape[0]
        chunks = (keys[s:s + chunk_size] for s in range(0, n, chunk_size))
    else:
        keys = host(keys).astype(np.uint32, copy=False)
        n = keys.shape[0]
        stream = torch.cuda.Stream(device) if device.type == "cuda" else None
        chunks = (_take_chunk(staged, device) for staged in _prefetch_map(
            lambda c: _stage_chunk(c, device, stream),
            [keys[s:s + chunk_size] for s in range(0, n, chunk_size)]))
    if n == 0:
        return SortedRun(lengths=torch.zeros(0, dtype=torch.int32,
                                             device=device),
                         keys=to_device(keys, device))
    return _sort_chunks(chunks, algorithm=algorithm, capacity=capacity,
                        on_overflow=on_overflow, validate=validate,
                        merge_engine=merge_engine, device=device)


def chunked_sort_words(words, chunk_size: int = DEFAULT_CHUNK,
                       algorithm: str = "pallas",
                       capacity: int | None = None,
                       store=None, supervisor=None,
                       validate: str = "off",
                       on_overflow: str = "raise",
                       merge_engine: str = "auto",
                       device="cuda") -> list:
    """Words front-end of :func:`chunked_sort_packed`: each chunk is packed
    (at the global width, so every run has the same lanes) and staged on
    the worker thread while the previous chunk sorts; the merged run is
    unpacked once. Returns the words in shortlex order; the arguments are
    :func:`chunked_sort_packed`'s."""
    _check_args(validate, chunk_size, store, supervisor)
    device = resolve_device(device)
    words = list(words)
    if not words:
        return []
    width = max(packing.byte_length(w) for w in words)
    stream = torch.cuda.Stream(device) if device.type == "cuda" else None
    chunks = (_take_chunk(staged, device) for staged in _prefetch_map(
        lambda ws: _stage_chunk(packing.pack_words(ws, width=width), device,
                                stream),
        [words[i:i + chunk_size] for i in range(0, len(words), chunk_size)]))
    run = _sort_chunks(chunks, algorithm=algorithm, capacity=capacity,
                       on_overflow=on_overflow, validate=validate,
                       merge_engine=merge_engine, device=device)
    return packing.unpack_words(host(run.keys))
