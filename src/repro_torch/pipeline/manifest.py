"""Run manifests + resumable run storage for the chunked ingest — the
counterpart of ``repro.pipeline.manifest``, on the same files.

Each completed :class:`~repro_torch.pipeline.ingest.SortedRun` gets a
:class:`RunManifest`: chunk id, exact element count, dense per-length
histogram, shortlex min/max key, and an order-independent content digest
(``pipeline/validate.py``), field for field the reference's. ``pipeline.
merge`` reconciles every run's count against its manifest before merging,
and ``validate.check_chunked`` holds the merged output to the manifests.
:class:`RunStore` persists runs through ``checkpoint/manager.py``'s atomic
tmp-then-rename snapshots (a crash mid-write can never leave a torn run;
the manifest lives in the snapshot's ``extra`` metadata, readable without
loading any array). A store written by either package resumes in the
other.

Resume protocol (``chunked_sort_*(store=...)``): for each chunk, if the
store holds a manifest whose count **and input digest** match the incoming
chunk, the stored run is loaded instead of re-sorted — the digest check
makes a stale store (same path, different dataset) recompute instead of
silently merging foreign data. ``pipeline/merge`` then reconciles every
run's manifest count before any merge round runs.
"""

from __future__ import annotations

import logging
import os
from dataclasses import asdict, dataclass
from typing import Optional, Tuple

import numpy as np

from ..checkpoint import manager as ckpt
from .validate import host, keys_digest, length_histogram_of

__all__ = ["RunManifest", "RunStore"]


@dataclass(frozen=True)
class RunManifest:
    """Invariant summary of one sorted run — everything the merge and the
    validation gate need to reconcile the run without rescanning it."""

    chunk_id: int
    count: int
    lanes: int                           # uint32 key lanes per word
    length_histogram: Tuple[int, ...]    # dense per-byte-length counts
    min_key: Optional[Tuple[int, ...]]   # (length, *lanes) of the first row
    max_key: Optional[Tuple[int, ...]]   # (length, *lanes) of the last row
    digest: int                          # order-independent content digest

    @classmethod
    def from_run(cls, run, chunk_id: int) -> "RunManifest":
        """Summarise a :class:`~repro_torch.pipeline.ingest.SortedRun`
        (copies the run to the host once; O(count) host work)."""
        lengths = host(run.lengths)
        keys = host(run.keys)
        n, lanes = keys.shape
        hist = length_histogram_of(lengths, 4 * lanes + 1)
        row = lambda i: (int(lengths[i]), *(int(v) for v in keys[i]))  # noqa: E731
        return cls(chunk_id=int(chunk_id), count=int(n), lanes=int(lanes),
                   length_histogram=tuple(int(c) for c in hist),
                   min_key=row(0) if n else None,
                   max_key=row(n - 1) if n else None,
                   digest=keys_digest(keys))

    def to_json(self) -> dict:
        return asdict(self)

    @classmethod
    def from_json(cls, d: dict) -> "RunManifest":
        return cls(chunk_id=int(d["chunk_id"]), count=int(d["count"]),
                   lanes=int(d["lanes"]),
                   length_histogram=tuple(d["length_histogram"]),
                   min_key=tuple(d["min_key"]) if d["min_key"] is not None
                   else None,
                   max_key=tuple(d["max_key"]) if d["max_key"] is not None
                   else None,
                   digest=int(d["digest"]))


class RunStore:
    """Directory of completed sorted runs keyed by chunk id.

    Each run is one ``checkpoint`` snapshot (``step_<chunk_id>/``):
    ``lengths`` (int32) + ``keys`` (uint32) (+ ``packed0``, ``packed1``, the
    uint32 rank-key lanes the chunk sort emitted, so a resumed run re-enters
    the merge without re-packing), with the :class:`RunManifest` in the
    snapshot's ``extra`` metadata. Writes are atomic (tmp dir + one
    ``os.replace``), so every manifest the store reports corresponds to a
    fully landed run — the resume discovery needs no journal."""

    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        # a job killed mid-save leaves .tmp_<N> droppings short of their
        # atomic rename; sweep them on open so they never accumulate and a
        # resume only ever sees fully landed snapshots
        swept = ckpt.sweep_tmp(directory)
        if swept:
            logging.getLogger("repro_torch.pipeline").warning(
                "%s: swept %d half-written snapshot(s) %s on open",
                type(self).__name__, len(swept), swept)

    def completed(self) -> list:
        """Chunk ids with fully landed runs, ascending."""
        return ckpt.list_steps(self.directory)

    def manifest(self, chunk_id: int) -> Optional[RunManifest]:
        if chunk_id not in set(ckpt.list_steps(self.directory)):
            return None
        extra = ckpt.read_manifest(self.directory, chunk_id).get("extra")
        return RunManifest.from_json(extra) if extra is not None else None

    def put(self, manifest: RunManifest, run) -> None:
        """Persist one completed run (synchronous + atomic: when this
        returns, the run survives a kill). A run on the card is copied to
        the host here, on the current stream."""
        tree = {"lengths": host(run.lengths), "keys": host(run.keys)}
        if run.packed is not None:
            for i, p in enumerate(run.packed):
                tree[f"packed{i}"] = host(p)
        ckpt.save(self.directory, manifest.chunk_id, tree,
                  extra=manifest.to_json())

    def load(self, chunk_id: int, device="cuda"):
        """Load a stored run's tensors onto ``device``: ``(lengths, keys,
        packed_or_None)`` (``pipeline.ingest._run_from_arrays`` rebuilds
        the ``SortedRun``)."""
        man = ckpt.read_manifest(self.directory, chunk_id)
        target = {e["name"]: np.empty(e["shape"], dtype=e["dtype"])
                  for e in man["leaves"]}
        tree = ckpt.restore(self.directory, chunk_id, target, device)
        packed = tuple(tree[n] for n in sorted(tree)
                       if n.startswith("packed")) or None
        return tree["lengths"], tree["keys"], packed
