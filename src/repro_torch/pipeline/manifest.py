"""Run manifests for the chunked ingest — ``RunManifest`` of
``repro.pipeline.manifest``, field for field.

Each completed :class:`~repro_torch.pipeline.ingest.SortedRun` gets a
:class:`RunManifest`: chunk id, exact element count, dense per-length
histogram, shortlex min/max key, and an order-independent content digest
(``pipeline/validate.py``). ``pipeline.merge`` reconciles every run's count
against its manifest before merging, and ``validate.check_chunked`` holds
the merged output to the manifests. The resumable ``RunStore`` waits for
the checkpoint manager (ROADMAP A8).
"""

from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Optional, Tuple

from .validate import host, keys_digest, length_histogram_of

__all__ = ["RunManifest"]


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
