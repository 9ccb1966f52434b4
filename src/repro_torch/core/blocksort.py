"""Hierarchical multi-block sort — the counterpart of
``repro.core.blocksort``.

  1. split each row into ``nb`` blocks of ``block_size`` columns,
  2. sort every block locally with the bitonic (or OETS) row kernel — one
     launch over all blocks of all rows,
  3. merge runs pairwise: round ``k`` merges every pair of adjacent sorted
     runs of ``block_size * 2^k`` columns by merge path, one launch out of
     place between two buffers. After ``ceil(log2 nb)`` rounds every row is
     sorted.

The reference runs ``nb`` alternating even/odd rounds of its block-pair
merge network instead (odd-even transposition lifted from columns to
blocks, ``repro/core/blocksort.py:90-112``); each round reads and writes
the whole tensor, so the port's rounds make ``ceil(log2 nb)`` passes where
the reference's make ``nb``. The merge is stable and compares every lane: a
tuple sort whose tuples are all distinct or bit-equal has one answer, so
the two agree bit for bit there; float ties that compare equal but differ
in bits (``-0.0`` and ``+0.0``, NaN payloads) may fall in another order.

The block cap comes from the H100's shared memory, not the TPU's VMEM: the
network merge kernel holds a pair's whole ``2B`` window of every array in
shared memory, ``2 B x arrays x 4 B <= 227 KB``, so ``B <= 4096`` for the
main path's four word lanes; the cap stays the block's bound, and the block
size changes no result.
"""

from __future__ import annotations

import torch

from ..kernels.bitonic_kernel import bitonic_rows_lex
from ..kernels.lex import as_bits, dtype_code
from ..kernels.merge_kernel import max_merge_block, merge_pairs_lex
from ..kernels.oets_kernel import oets_rows_lex
from ..kernels.ops import _as_rows, _next_pow2, _pad_stack, _unstack
from ..runtime import trace

__all__ = ["block_sort", "block_sort_kv", "block_sort_lex",
           "block_sort_views", "default_block_size"]

_MIN_BLOCK = 128
_DEFAULT_MIN_BLOCK = 512
_TARGET_BLOCKS = 16       # blocks a row; merge rounds = ceil(log2 blocks)


def default_block_size(n: int, kv: bool = False,
                       n_arrays: int | None = None) -> int:
    """Cost-model block pick for an ``n``-column row: about
    ``_TARGET_BLOCKS`` blocks, at least 512 columns, and at most the merge
    kernel's shared-memory cap for ``n_arrays`` arrays (``kv=True`` is
    shorthand for 2)."""
    t = n_arrays if n_arrays is not None else (2 if kv else 1)
    cap = max(_MIN_BLOCK, max_merge_block(t))
    b = _next_pow2(max(1, -(-n // _TARGET_BLOCKS)))
    return max(_DEFAULT_MIN_BLOCK, min(cap, b))


def _validate_block(block_size, n: int, n_arrays: int) -> int:
    b = block_size or default_block_size(n, n_arrays=n_arrays)
    if b < _MIN_BLOCK or b & (b - 1):
        raise ValueError(
            f"block_size must be a power of two >= {_MIN_BLOCK}, got {b}")
    if b > max_merge_block(n_arrays):
        raise ValueError(
            f"block_size {b} exceeds the merge kernel's cap of "
            f"{max_merge_block(n_arrays)} for {n_arrays} arrays: a pair "
            "window must fit one block's shared memory")
    return b


def _merge_rounds(x: torch.Tensor, codes, nb: int, block: int) -> torch.Tensor:
    """``ceil(log2 nb)`` rounds of merge-path merges of adjacent runs over
    the ``(A, R, nb * block)`` tensor ``x`` of sorted blocks, the run width
    doubling from ``block``, between ``x`` and one more buffer; returns the
    buffer that holds the sorted rows."""
    y = torch.empty_like(x)
    run, rounds = block, 0
    while run < nb * block:
        merge_pairs_lex(x, y, codes, run=run)
        x, y = y, x
        run *= 2
        rounds += 1
    trace.count("blocksort.rounds", rounds)
    return x


def block_sort_views(views, codes, *, block_size: int | None = None,
                     local_algorithm: str = "bitonic") -> torch.Tensor:
    """Block-sort the rows of ``(R, n)`` int32 lane views with codes
    ``codes``; returns the sorted ``(A, R, n)`` result."""
    if local_algorithm not in ("bitonic", "oets"):
        raise ValueError(f"unknown local algorithm {local_algorithm!r}")
    rows, n = views[0].shape
    b = _validate_block(block_size, n, len(views))
    nb = -(-n // b)
    # every array pads with its own sentinel, so the padding tuple is the
    # lex maximum and never displaces a real element
    x = _pad_stack(views, codes, nb * b)
    local = bitonic_rows_lex if local_algorithm == "bitonic" else oets_rows_lex
    local(x.view(len(views), rows * nb, b), codes)
    if nb > 1:
        x = _merge_rounds(x, codes, nb, b)
    return x[:, :, :n]


def block_sort_lex(arrs, *, block_size: int | None = None,
                   local_algorithm: str = "bitonic"):
    """Sort a tuple of same-shape 1-D tensors or ``(rows, cols)`` batches
    as lexicographic tuples (lane 0 most significant; trailing arrays are
    payload/tie-break lanes). Returns the sorted tuple.

    ``block_size``: columns per block (a power of two >= 128, at most the
    shared-memory cap); None = the cost model. ``local_algorithm``:
    'bitonic' (default) or 'oets' for the in-block sort."""
    arrs = list(arrs)
    if not arrs:
        raise ValueError("need at least one array to sort")
    if any(a.shape != arrs[0].shape for a in arrs[1:]):
        raise ValueError("all lex arrays must have identical shapes")
    views = [_as_rows(a) for a in arrs]
    vec = views[0][1]
    a2 = [v[0] for v in views]
    if 0 in a2[0].shape:
        return tuple(arrs)
    codes = [dtype_code(a.dtype) for a in arrs]
    x = block_sort_views([as_bits(a) for a in a2], codes,
                         block_size=block_size,
                         local_algorithm=local_algorithm)
    out = _unstack(x, [a.dtype for a in arrs])
    return tuple(o[0] for o in out) if vec else out


def block_sort(x: torch.Tensor, *, block_size: int | None = None,
               local_algorithm: str = "bitonic") -> torch.Tensor:
    """Sort a 1-D tensor or each row of a ``(rows, cols)`` tensor."""
    (out,) = block_sort_lex((x,), block_size=block_size,
                            local_algorithm=local_algorithm)
    return out


def block_sort_kv(keys: torch.Tensor, vals: torch.Tensor, *,
                  block_size: int | None = None,
                  local_algorithm: str = "bitonic"):
    """Key-value variant of :func:`block_sort`; ``vals`` rides the same
    permutation as the 2nd (tie-break) lex lane."""
    if keys.shape != vals.shape:
        raise ValueError("keys and vals must have identical shapes")
    return block_sort_lex((keys, vals), block_size=block_size,
                          local_algorithm=local_algorithm)
