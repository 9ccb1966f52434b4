"""The port's kernels: seven hand-written CUDA kernels for Hopper (sm_90a),
each beside its plain PyTorch version in the same module — ``oets_kernel``
(B1), ``bitonic_kernel`` (B2), ``distribute_kernel`` (B3), ``merge_kernel``
(B4), ``runmerge_kernel`` (B5), ``kway_kernel`` (B6) and
``partition_kernel`` (B7); the shared key plane ``lex``; the rank-key
packing and merge-path ranks ``keypack``; the public ``ops``; ``ref``,
the plain oracles the tests hold the row kernels to; and ``adversarial``,
the inputs the card's tests and ``chip_smoke.py`` sweep B1, B3, B4, B5 and
B7 with. ``_build`` compiles
and binds the kernels on their first CUDA launch and counts their launches
(``KERNELS``).
"""

from ._build import KERNELS
from .keypack import (PackedKeys, PackPlan, bias_to_u32, cmp_from_packed,
                      lex_searchsorted, merge_take_packed, pack_rank_keys,
                      pack_shortlex, packed_cmp_lanes, packed_searchsorted,
                      plan_pack, shortlex_max_values, unpack_rank_keys)
from .lex import (from_order_bits, lex_gt_lanes, lex_merge_take,
                  lex_rank_count, map_lanes, order_view, select_lanes,
                  sentinel_for, to_order_bits)
from .ops import (DEFAULT_MERGE_BLOCK, BucketizeResult, bucketize,
                  choose_kway_engine, choose_lex_engine, choose_merge_engine,
                  choose_plan, distribute, execution_provenance,
                  merge_runs_lex, merge_sorted, merge_sorted_lex,
                  partition_rows, scatter_to_buckets, segmented_sort, sort,
                  sort_kv, sort_lex, sort_rows, sort_rows_kv, sort_rows_lex)
from .ref import partition_rows_ref, sort_rows_kv_ref, sort_rows_ref

__all__ = [
    "KERNELS", "sort", "sort_kv", "sort_lex", "segmented_sort", "distribute",
    "bucketize", "BucketizeResult", "scatter_to_buckets", "choose_plan",
    "choose_lex_engine", "execution_provenance", "sort_rows", "sort_rows_kv",
    "sort_rows_lex", "partition_rows", "to_order_bits", "from_order_bits",
    "order_view", "sentinel_for", "lex_gt_lanes", "map_lanes",
    "select_lanes", "PackPlan", "PackedKeys", "plan_pack", "bias_to_u32",
    "pack_rank_keys", "pack_shortlex", "shortlex_max_values",
    "unpack_rank_keys", "packed_cmp_lanes", "cmp_from_packed",
    "lex_searchsorted", "packed_searchsorted", "merge_take_packed",
    "lex_rank_count", "lex_merge_take", "choose_merge_engine",
    "merge_sorted_lex", "merge_sorted", "choose_kway_engine",
    "merge_runs_lex", "DEFAULT_MERGE_BLOCK", "sort_rows_ref",
    "sort_rows_kv_ref", "partition_rows_ref",
]
