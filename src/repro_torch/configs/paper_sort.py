"""The paper's own workload as a config: dataset scales, bucket policy and
algorithm selection for the bucketed parallel sort.

The paper's two datasets are matched by word count (190 KB / 1.38 MB of
cleaned Shakespeare); `algorithm` picks the in-bucket comparator network
('oets' = paper-faithful parallel bubble sort) and `merge` the device-level
exchange strategy of the distributed sort.

A copy of ``repro.configs.paper_sort``, field for field, so both packages
read the same datasets. The port sorts with ``algorithm='pallas'`` (its
hand-written kernel path) whatever ``algorithm`` says; the traced
'oets'/'bitonic' networks and 'xla' are not ported yet (ROADMAP A12).
``merge`` is the odd-even engine's merge of the mesh tier
(``core.distributed.distributed_sort_lex(merge=...)``) and ``devices`` its
width: the ranks of that sort, or the destinations of
``distributed_chunked_sort_lex``.
"""

import dataclasses

__all__ = ["SortConfig", "DS1", "DS2", "CONFIG"]


@dataclasses.dataclass(frozen=True)
class SortConfig:
    name: str
    n_words: int              # corpus size (paper: ~30k / ~230k words)
    max_word_len: int = 15
    algorithm: str = "oets"   # oets (paper) | bitonic (beyond-paper) | xla
    merge: str = "bitonic"    # device-level merge: resort | bitonic | take
    devices: int = 8          # distributed-sort width for the example
    seed: int = 0


DS1 = SortConfig(name="ds1-190KB", n_words=30_000)
DS2 = SortConfig(name="ds2-1.38MB", n_words=230_000)

# default experiment config (the paper's headline comparison runs both)
CONFIG = DS1
