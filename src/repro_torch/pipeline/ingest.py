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

Robustness, as in the reference: with a ``RunStore`` every sorted run is
copied to the host and persisted before the next chunk sorts, and a chunk
whose intact run is already stored (same count, same input digest — the
digest of a host chunk is taken on the worker beside its staging) is loaded,
not sorted; with a ``SortSupervisor`` each chunk sort runs as its
``'ingest_chunk'`` stage and the merge as ``'streaming_combine'`` or
``'merge_round'``.
"""

from __future__ import annotations

import logging
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..checkpoint.manager import CorruptSnapshotError
from ..core import packing
from ..core.bucketing import sorted_packed
from ..interop import resolve_device, to_device
from ..kernels.keypack import (cmp_from_packed, packed_cmp_lanes,
                               shortlex_max_values)
from ..runtime import trace
from .manifest import RunManifest
from .merge import merge_runs
from .validate import check_chunked, host, keys_digest

__all__ = ["DEFAULT_CHUNK", "SortedRun", "sorted_run",
           "chunked_sort_packed", "chunked_sort_words"]

log = logging.getLogger("repro_torch.pipeline")

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


def _run_from_arrays(lengths, keys, packed, device="cuda") -> SortedRun:
    """A :class:`SortedRun` on ``device`` from a stored run's fields (numpy
    arrays or tensors, as ``RunStore.load`` gives them)."""
    return SortedRun(
        lengths=to_device(lengths, device), keys=to_device(keys, device),
        packed=tuple(to_device(p, device) for p in packed) if packed
        else None)


def _resume_chunk(chunk, chunk_id: int, digest, store, device):
    """The stored run of ``chunk`` and its manifest, or ``None`` where the
    store holds no intact run of the same multiset (logged)."""
    try:
        man = store.manifest(chunk_id)
    except CorruptSnapshotError as e:
        log.warning("run store: chunk %d manifest unreadable (%s) — "
                    "re-ingesting", chunk_id, e)
        return None
    if man is None:
        return None
    # A stored run matches iff it holds the same multiset as the incoming
    # chunk — the digest is order-independent, so the *input* chunk digests
    # straight against the *sorted* run's manifest. A mismatch means the
    # store is stale (same path, different dataset): recompute instead of
    # merging foreign data.
    if man.count != int(chunk.shape[0]) or man.digest != (
            keys_digest(chunk) if digest is None else digest):
        log.warning("run store: chunk %d manifest does not match incoming "
                    "data (stale store?) — re-ingesting", chunk_id)
        return None
    try:
        loaded = _run_from_arrays(*store.load(chunk_id, device),
                                  device=device)
    except CorruptSnapshotError as e:
        # torn/truncated artifact (kill mid-write never produces this — the
        # rename is atomic — but disk damage can): the chunk is still in
        # hand, so recompute, don't fail
        log.warning("run store: chunk %d unreadable (%s) — re-ingesting",
                    chunk_id, e)
        return None
    if int(loaded.lengths.shape[0]) != man.count:
        log.warning("run store: chunk %d loaded %d row(s) but manifest "
                    "records %d — re-ingesting", chunk_id,
                    int(loaded.lengths.shape[0]), man.count)
        return None
    return loaded, man


def _ingest_chunk(chunk, chunk_id: int, digest, *, algorithm: str, capacity,
                  on_overflow: str, store, supervisor, need_manifest: bool,
                  device):
    """One ``(run, manifest)`` for a chunk on ``device`` — resumed from the
    store when an intact matching run is persisted there, else sorted
    (through the supervisor's ``ingest_chunk`` stage when one is given) and
    persisted. ``digest``: the chunk's ``keys_digest`` where the caller
    took it on the host, else ``None`` (taken here if a resume needs it)."""
    if store is not None:
        resumed = _resume_chunk(chunk, chunk_id, digest, store, device)
        if resumed is not None:
            return resumed

    def launch():
        return sorted_run(chunk, algorithm=algorithm, capacity=capacity,
                          on_overflow=on_overflow, device=device)

    if supervisor is not None:
        run = supervisor.run_stage("ingest_chunk", launch)
    else:
        run = launch()
    if store is None:
        return run, (RunManifest.from_run(run, chunk_id) if need_manifest
                     else None)
    # one copy to the host serves the manifest and the store; put returns
    # only once the run has landed, so it survives a kill from here on
    on_host = SortedRun(lengths=host(run.lengths), keys=host(run.keys),
                        packed=None if run.packed is None
                        else tuple(host(p) for p in run.packed))
    man = RunManifest.from_run(on_host, chunk_id)
    store.put(man, on_host)
    return run, man


def _merged_run(runs, manifests=None, supervisor=None,
                merge_engine: str = "auto") -> SortedRun:
    if len(runs) == 1:
        return runs[0]
    return SortedRun.from_lanes(merge_runs(
        [r.lanes() for r in runs], engine=merge_engine,
        cmp_runs=[r.cmp_lanes() for r in runs], manifests=manifests,
        supervisor=supervisor))


def _check_args(validate: str, chunk_size: int):
    if validate not in _VALIDATE_MODES:
        raise ValueError(f"validate must be one of {_VALIDATE_MODES}")
    if chunk_size < 1:
        raise ValueError("chunk_size must be >= 1")


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


def _staged_chunks(pack, items, digest: bool, device: torch.device):
    """``(device tensor, digest or None)`` for each item: on the prefetch
    worker, ``pack(item)`` gives the chunk's packed host rows, which are
    digested (where ``digest``) and staged, while the previous chunk
    sorts."""
    stream = torch.cuda.Stream(device) if device.type == "cuda" else None

    def stage(chunk_item):
        chunk, item = chunk_item
        with trace.span("ingest.stage", chunk=chunk):
            rows = pack(item)
            return (_stage_chunk(rows, device, stream),
                    keys_digest(rows) if digest else None)

    return ((_take_chunk(staged, device), d)
            for staged, d in _prefetch_map(stage, enumerate(items)))


def _prefetch_map(fn, items):
    """Yield ``fn(item)`` in order, computing the *next* call on a worker
    thread while the consumer processes the current result."""
    items = list(items)
    if not items:
        return
    with ThreadPoolExecutor(max_workers=1) as ex:
        fut = ex.submit(fn, items[0])
        for nxt in items[1:]:
            with trace.span("ingest.wait"):
                cur = fut.result()
            fut = ex.submit(fn, nxt)
            yield cur
        with trace.span("ingest.wait"):
            last = fut.result()
        yield last


def _sort_chunks(chunks, *, algorithm, capacity, on_overflow, validate,
                 merge_engine, store, supervisor, device) -> SortedRun:
    """Sort (or resume) every chunk — ``(device tensor, digest or None)``
    pairs — into a run, merge the runs, and run the validation gate."""
    runs, manifests = [], []
    for ci, (keys, digest) in enumerate(chunks):
        cap = capacity if capacity is not None else int(keys.shape[0])
        with trace.span("ingest.chunk_sort", chunk=ci):
            run, man = _ingest_chunk(
                keys, ci, digest, algorithm=algorithm, capacity=cap,
                on_overflow=on_overflow, store=store, supervisor=supervisor,
                need_manifest=validate != "off", device=device)
        runs.append(run)
        manifests.append(man)
    track = store is not None or validate != "off"
    with trace.span("ingest.merge"):
        merged = _merged_run(runs, manifests=manifests if track else None,
                             supervisor=supervisor,
                             merge_engine=merge_engine)
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
    (pairwise rounds) — see ``pipeline.merge.merge_runs``.

    Robustness, as the reference's:

    * ``store`` — a :class:`~repro_torch.pipeline.manifest.RunStore`. Every
      sorted run is persisted (copied to the host, written atomically)
      before the next chunk sorts, and chunks whose intact runs are already
      stored are *loaded, not re-sorted* — a killed job resumes from its
      completed runs. A store the reference wrote resumes here, and the
      reverse.
    * ``supervisor`` — a ``runtime.SortSupervisor``; chunk sorts run as its
      ``ingest_chunk`` stage and the merge as ``streaming_combine`` (k-way)
      or one ``merge_round`` a tournament round, with bounded retry on
      transient ``StageFailure``.

    Host (numpy) input stays on the host until its chunk is staged, chunk
    ``i+1``'s upload (and, with a store, its digest) overlapping chunk
    ``i``'s sort; a tensor already on ``device`` is digested, where a
    resume needs it, through one copy back."""
    _check_args(validate, chunk_size)
    device = resolve_device(device)
    if isinstance(keys, torch.Tensor) and keys.device.type == device.type:
        n = keys.shape[0]
        chunks = ((keys[s:s + chunk_size], None)
                  for s in range(0, n, chunk_size))
    else:
        keys = host(keys).astype(np.uint32, copy=False)
        n = keys.shape[0]
        chunks = _staged_chunks(
            lambda c: c, [keys[s:s + chunk_size]
                          for s in range(0, n, chunk_size)],
            store is not None, device)
    if n == 0:
        return SortedRun(lengths=torch.zeros(0, dtype=torch.int32,
                                             device=device),
                         keys=to_device(keys, device))
    return _sort_chunks(chunks, algorithm=algorithm, capacity=capacity,
                        on_overflow=on_overflow, validate=validate,
                        merge_engine=merge_engine, store=store,
                        supervisor=supervisor, device=device)


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
    _check_args(validate, chunk_size)
    device = resolve_device(device)
    words = list(words)
    if not words:
        return []
    width = max(packing.byte_length(w) for w in words)
    chunks = _staged_chunks(
        lambda ws: packing.pack_words(ws, width=width),
        [words[i:i + chunk_size] for i in range(0, len(words), chunk_size)],
        store is not None, device)
    run = _sort_chunks(chunks, algorithm=algorithm, capacity=capacity,
                       on_overflow=on_overflow, validate=validate,
                       merge_engine=merge_engine, store=store,
                       supervisor=supervisor, device=device)
    return packing.unpack_words(host(run.keys))
