"""The paper's pipeline in the port: packing, bucketing and blocksort."""

from .blocksort import (block_sort, block_sort_kv, block_sort_lex,
                        default_block_size)
from .bucketing import (Buckets, bucketed_sort_words, bucketize_packed,
                        bucketize_words, sort_buckets, sorted_packed)
from .packing import (SENTINEL_U32, byte_length, lanes_for_width, pack_words,
                      unpack_words)

__all__ = ["Buckets", "bucketize_words", "bucketize_packed", "sort_buckets",
           "sorted_packed", "bucketed_sort_words", "block_sort",
           "block_sort_kv", "block_sort_lex", "default_block_size",
           "pack_words", "unpack_words", "byte_length", "lanes_for_width",
           "SENTINEL_U32"]
