"""The run tier of the port: sort inputs of any length in chunks and merge
the sorted runs — the counterpart of ``repro.pipeline``.

  ``ingest``     chunked sort: pack, sort each chunk on the device
                 (``core.bucketing.sorted_packed``) into a sorted run, merge
                 the runs; ``chunked_sort_words`` is the words front-end.
  ``merge``      the run combiner: one k-way pass (kernel B6) or the
                 pairwise tournament (kernel B5) over the shortlex tuples.
  ``histogram``  the shared length-histogram / bucket-assignment utility
                 (numpy only).
  ``manifest``   per-run invariant summaries (:class:`RunManifest`) and the
                 atomic resumable run store (:class:`RunStore`) behind
                 ``chunked_sort_*(store=...)``, on the reference's files.
  ``shards``     per-destination output shards (:class:`ShardStore`,
                 :class:`ShardedRun`): the spill of the mesh tier's
                 ``core.distributed.distributed_chunked_sort_lex``.
  ``validate``   the invariant gate: sortedness, count and histogram
                 conservation, order-independent content digests
                 (``validate='off'|'cheap'|'full'``), and the shards'
                 metadata-only ``check_sharded``.
"""

from .histogram import (assign_buckets, bucket_of, length_histogram,
                        quantile_bounds)
from .ingest import (DEFAULT_CHUNK, SortedRun, chunked_sort_packed,
                     chunked_sort_words, sorted_run)
from .manifest import RunManifest, RunStore
from .merge import merge_runs, merge_two
from .shards import ShardedRun, ShardStore
from .validate import (ValidationError, check_chunked, check_lanes_sorted,
                       check_multiset, check_run, check_sharded, keys_digest,
                       length_histogram_of, multiset_digest)

__all__ = [
    "DEFAULT_CHUNK", "SortedRun", "sorted_run",
    "chunked_sort_packed", "chunked_sort_words",
    "merge_runs", "merge_two",
    "RunManifest", "RunStore", "ShardStore", "ShardedRun",
    "ValidationError", "multiset_digest", "keys_digest",
    "length_histogram_of", "check_lanes_sorted", "check_multiset",
    "check_run", "check_chunked", "check_sharded",
    "length_histogram", "assign_buckets", "bucket_of", "quantile_bounds",
]
