"""The paper's pipeline in the port: packing, bucketing, blocksort, the
comparator networks as torch ops (``oets``, the paper's parallel bubble
sort, and ``bitonic``) and the mesh tier (``distributed``: odd-even and
sample engines over ``torch.distributed``, and the out-of-core mesh chunked
sort)."""

from .bitonic import (bitonic_merge, bitonic_merge_kv, bitonic_merge_lex,
                      bitonic_sort, bitonic_sort_kv)
from .blocksort import (block_sort, block_sort_kv, block_sort_lex,
                        default_block_size)
from .bucketing import (Buckets, bucketed_sort_words, bucketize_packed,
                        bucketize_words, sort_buckets, sorted_packed)
from .distributed import (SampleSortResult, choose_engine,
                          distributed_chunked_sort_lex, distributed_sort,
                          distributed_sort_kv, distributed_sort_lex,
                          local_merge, odd_even_block_sort,
                          odd_even_block_sort_lex, sample_sort,
                          sample_sort_exact, sample_sort_lex)
from .oets import lex_gt, oets_argsort, oets_sort, oets_sort_kv
from .packing import (SENTINEL_U32, byte_length, lanes_for_width, pack_words,
                      unpack_words)

__all__ = ["Buckets", "bucketize_words", "bucketize_packed", "sort_buckets",
           "sorted_packed", "bucketed_sort_words", "block_sort",
           "block_sort_kv", "block_sort_lex", "default_block_size",
           "pack_words", "unpack_words", "byte_length", "lanes_for_width",
           "SENTINEL_U32", "bitonic_sort", "bitonic_sort_kv", "bitonic_merge",
           "bitonic_merge_kv", "bitonic_merge_lex", "choose_engine",
           "odd_even_block_sort", "odd_even_block_sort_lex", "sample_sort",
           "sample_sort_lex", "sample_sort_exact", "SampleSortResult",
           "distributed_sort", "distributed_sort_kv", "distributed_sort_lex",
           "distributed_chunked_sort_lex", "local_merge", "oets_sort",
           "oets_sort_kv", "oets_argsort", "lex_gt"]
