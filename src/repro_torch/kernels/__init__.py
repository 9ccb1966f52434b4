"""The port's kernels: four hand-written CUDA kernels for Hopper (sm_90a),
each beside its plain PyTorch version in the same module — ``oets_kernel``
(B1), ``bitonic_kernel`` (B2), ``distribute_kernel`` (B3) and
``merge_kernel`` (B4); the shared key plane ``lex``; the rank-key packing
``keypack``; and the public ``ops``. ``_build`` compiles and binds the
kernels on their first CUDA launch and counts their launches (``KERNELS``).
"""

from ._build import KERNELS
from .keypack import (PackedKeys, PackPlan, pack_rank_keys, pack_shortlex,
                      plan_pack, shortlex_max_values)
from .lex import (from_order_bits, lex_gt_lanes, order_view, sentinel_for,
                  to_order_bits)
from .ops import (BucketizeResult, bucketize, choose_lex_engine, choose_plan,
                  distribute, execution_provenance, scatter_to_buckets,
                  segmented_sort, sort, sort_kv, sort_lex, sort_rows_lex)

__all__ = [
    "KERNELS", "sort", "sort_kv", "sort_lex", "segmented_sort", "distribute",
    "bucketize", "BucketizeResult", "scatter_to_buckets", "choose_plan",
    "choose_lex_engine", "execution_provenance", "sort_rows_lex",
    "to_order_bits", "from_order_bits", "order_view", "sentinel_for",
    "lex_gt_lanes", "PackPlan", "PackedKeys", "plan_pack", "pack_rank_keys",
    "pack_shortlex", "shortlex_max_values",
]
