"""The run tier of the port: sort inputs of any length in chunks and merge
the sorted runs — the counterpart of ``repro.pipeline``.

  ``ingest``    chunked sort: pack, sort each chunk on the device
                (``core.bucketing.sorted_packed``) into a sorted run, merge
                the runs; ``chunked_sort_words`` is the words front-end.
  ``merge``     the run combiner: one k-way pass (kernel B6) or the
                pairwise tournament (kernel B5) over the shortlex tuples.
  ``manifest``  per-run invariant summaries (:class:`RunManifest`).
  ``validate``  the invariant gate: sortedness, count and histogram
                conservation, order-independent content digests
                (``validate='off'|'cheap'|'full'``).

Not ported yet: the resumable ``RunStore``, the shard store and the length
histogram utilities (ROADMAP A8).
"""

from .ingest import (DEFAULT_CHUNK, SortedRun, chunked_sort_packed,
                     chunked_sort_words, sorted_run)
from .manifest import RunManifest
from .merge import merge_runs, merge_two
from .validate import (ValidationError, check_chunked, check_lanes_sorted,
                       check_multiset, check_run, keys_digest,
                       length_histogram_of, multiset_digest)

__all__ = [
    "DEFAULT_CHUNK", "SortedRun", "sorted_run",
    "chunked_sort_packed", "chunked_sort_words",
    "merge_runs", "merge_two", "RunManifest",
    "ValidationError", "multiset_digest", "keys_digest",
    "length_histogram_of", "check_lanes_sorted", "check_multiset",
    "check_run", "check_chunked",
]
