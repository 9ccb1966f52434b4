"""Data substrate of the port: synthetic corpora, the paper's
length-bucketed batching as a pipeline stage, and a prefetching host
loader."""

from .bucketing import LengthBucketedBatcher, padding_waste, plan_buckets
from .loader import ShardedLoader
from .synthetic import TokenStream, clean_text, synthetic_words, \
    words_from_text

__all__ = ["synthetic_words", "TokenStream", "clean_text", "words_from_text",
           "LengthBucketedBatcher", "plan_buckets", "padding_waste",
           "ShardedLoader"]
