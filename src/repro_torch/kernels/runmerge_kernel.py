"""B5: merge-path combine of two sorted runs, one output block at a time —
hand-written CUDA kernels (``csrc/runmerge.cu``) and their plain PyTorch
versions; the counterpart of ``repro.kernels.runmerge_kernel``.

  1. **Diagonal split** (:func:`merge_path_starts`): for every output block
     of ``block`` slots, the segments ``a[sa:ea)`` and ``b[sb:eb)`` that
     hold its outputs, ``(ea - sa) + (eb - sb) == block``. On a CUDA device
     the split kernel runs one merge-path co-rank search a block boundary
     (a warp each) over the compare lanes; the plain version ranks every
     element of ``a`` against ``b`` (``keypack.lex_searchsorted``, a before
     b on ties) and runs one ``torch.searchsorted`` over those ranks, the
     reference's jnp split.
  2. **Per-block merge** (:func:`runmerge`): a block's two segments are
     staged into one tile, each output finds its source by a co-rank search
     inside the tile (b only where b < a strictly), and every data lane is
     copied from its source.

Only the compare lanes are compared, never the whole tuple (the pipeline's
tuples are 10-18 arrays): the compare prefix is an order-preserving
refinement of the tuple — equal prefix, equal tuple — and the merge keeps a
before b and run order on ties, so the result is the stable merge, bit for
bit that of ``keypack.merge_take_packed``, on every lane type.

Runs travel stacked: ``(lanes, n)`` int32 bit views, the compare lanes in
their own stack (or the leading rows of the data stack).
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from ._build import Kernel
from .keypack import lex_searchsorted, packed_cmp_lanes
from .lex import F32, I32, U32, as_bits, codes_mask, dtype_code, from_bits, \
    lex_gt_keys, order_keys

__all__ = ["KERNEL", "SPLIT_KERNEL", "DEFAULT_MERGE_BLOCK", "MAX_CMP_LANES",
           "merge_path_starts", "merge_path_starts_plain", "merge_operands",
           "runmerge", "runmerge_plain", "merge_runs_lex_kernel",
           "stack_lanes", "check_block", "check_runs", "cmp_codes"]

KERNEL = Kernel("merge_runs_lex", "runmerge.cu", "runmerge_lex",
                [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_int,
                                         ctypes.c_uint] + [ctypes.c_int] * 4,
                replaces="src/repro/kernels/runmerge_kernel.py:54")
# the split, which the reference computes in jnp inside the TPU kernel's jit
SPLIT_KERNEL = Kernel("merge_path_starts", "runmerge.cu", "runmerge_starts",
                      [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_uint]
                      + [ctypes.c_int] * 4,
                      replaces="src/repro/kernels/runmerge_kernel.py:110")

# one output block per CTA: the reference's tile
DEFAULT_MERGE_BLOCK = 256
# compare lanes a merge takes: 1-9 run an instance each, 10-15 one that
# reads the count at run time; two-bit codes each in a 32-bit argument
MAX_CMP_LANES = 15
_INDEX_FILL = (1 << 31) - 1
_DTYPES = {U32: torch.uint32, I32: torch.int32, F32: torch.float32}


def stack_lanes(lanes) -> torch.Tensor:
    """Parallel 1-D 32-bit lanes as one contiguous ``(lanes, n)`` int32
    tensor of their bits."""
    return torch.stack([as_bits(a) for a in lanes])


def check_block(block: int) -> int:
    if block < 128 or block & (block - 1):
        raise ValueError("block must be a power of two >= 128")
    return block


def check_runs(runs) -> list:
    """``runs`` as a list of tuples; raises unless they share a non-zero
    arity of 1-D tensors."""
    runs = [tuple(r) for r in runs]
    if not runs or not runs[0] or any(len(r) != len(runs[0]) for r in runs):
        raise ValueError("runs must share a non-zero lane arity")
    if any(x.dim() != 1 for r in runs for x in r):
        raise ValueError("runs must be tuples of 1-D tensors")
    return runs


def cmp_codes(cmp_lanes) -> list:
    """The codes of the compare lanes; raises past :data:`MAX_CMP_LANES`."""
    codes = [dtype_code(a.dtype) for a in cmp_lanes]
    if len(codes) > MAX_CMP_LANES:
        raise ValueError(f"at most {MAX_CMP_LANES} compare lanes, got "
                         f"{len(codes)}")
    return codes


def _check_stacked(t: torch.Tensor, rows: int, what: str):
    if (t.dtype != torch.int32 or t.dim() != 2 or not t.is_contiguous()
            or t.shape[0] != rows):
        raise ValueError(f"{what}: expected contiguous stacked ({rows}, n) "
                         f"int32 lanes, got {tuple(t.shape)} {t.dtype}")


def merge_path_starts_plain(cmp_a: torch.Tensor, cmp_b: torch.Tensor,
                            codes: Sequence[int], block: int) -> torch.Tensor:
    """The plain split, the reference's jnp split in torch: the merge-path
    rank of every element of a (its index plus the elements of b strictly
    below it), then one ``torch.searchsorted`` of the block bounds over
    those ranks. Returns ``(2, nblocks + 1)`` int32."""
    na, nb = cmp_a.shape[1], cmp_b.shape[1]
    dev = cmp_a.device
    nblocks = -(-(na + nb) // block)

    def lanes(x):
        return [from_bits(r, _DTYPES[c]) for r, c in zip(x, codes)]

    rank_a = torch.arange(na, device=dev) + lex_searchsorted(
        lanes(cmp_b), lanes(cmp_a), side="left")
    bounds = torch.arange(nblocks + 1, device=dev) * block
    a_starts = torch.searchsorted(rank_a, bounds, side="left")
    b_starts = (bounds - a_starts).clamp(0, nb)
    return torch.stack([a_starts, b_starts]).to(torch.int32)


def merge_path_starts(cmp_a, cmp_b, block: int,
                      codes: Sequence[int] | None = None) -> torch.Tensor:
    """The diagonal split: ``(2, nblocks + 1)`` int32, row 0 the start of
    each output block's a-segment, row 1 its b-segment's, for sorted runs
    with compare lanes ``cmp_a`` and ``cmp_b`` (a before b on ties): each a
    sequence of 1-D tensors, or, with ``codes`` their lanes' codes, their
    stacked ``(n_cmp, n)`` int32 bits (:func:`stack_lanes`). A CPU tensor
    runs the plain version; a CUDA tensor launches the split kernel."""
    if codes is None:
        codes = cmp_codes(cmp_a)
        cmp_a, cmp_b = stack_lanes(cmp_a), stack_lanes(cmp_b)
    n_cmp = len(codes)
    if not 1 <= n_cmp <= MAX_CMP_LANES:
        raise ValueError(f"merge_path_starts: need 1 to {MAX_CMP_LANES} "
                         "compare lanes")
    _check_stacked(cmp_a, n_cmp, "merge_path_starts")
    _check_stacked(cmp_b, n_cmp, "merge_path_starts")
    if cmp_a.device.type == "cpu":
        return merge_path_starts_plain(cmp_a, cmp_b, codes, block)
    na, nb = cmp_a.shape[1], cmp_b.shape[1]
    if na + nb >= _INDEX_FILL:
        raise ValueError("merge_path_starts: runs of 2^31 - 1 elements or "
                         "more")
    nblocks = -(-(na + nb) // block)
    starts = torch.empty((2, nblocks + 1), dtype=torch.int32,
                         device=cmp_a.device)
    SPLIT_KERNEL(cmp_a.device, cmp_a.data_ptr(), cmp_b.data_ptr(),
                 starts.data_ptr(), n_cmp, codes_mask(codes), na, nb,
                 nblocks, block)
    return starts


def runmerge_plain(cmp_a, cmp_b, data_a, data_b, starts, codes: Sequence[int],
                   block: int) -> torch.Tensor:
    """The plain version, the kernel's steps over every block at once:
    each block's tile (its a-segment at the split's start, then its
    b-segment), every output slot's co-rank in the tile by a binary search
    over the compare lanes' order keys, its source (b only where b < a
    strictly), then one gather per data lane. Returns ``(n_arr, na + nb)``
    int32."""
    na, nb = cmp_a.shape[1], cmp_b.shape[1]
    total = na + nb
    if total == 0:
        return torch.cat([data_a, data_b], dim=1)
    dev = cmp_a.device
    s = starts.to(torch.int64)
    sa, sb = s[0, :-1, None], s[1, :-1, None]       # (nblocks, 1)
    ca, cb = s[0, 1:, None] - sa, s[1, 1:, None] - sb
    # a's element i at i, b's element j at na + j
    keys = order_keys(torch.cat([cmp_a, cmp_b], dim=1), codes)

    def less(p, q):                                  # keys[p] < keys[q]
        return lex_gt_keys(keys[:, q.clamp(0, total - 1)],
                           keys[:, p.clamp(0, total - 1)])

    d = torch.arange(block, device=dev)              # each slot's diagonal
    hi = torch.minimum(d, ca)
    lo = torch.minimum((d - cb).clamp(min=0), hi)
    for _ in range(block.bit_length() + 1):
        mid = (lo + hi) >> 1
        b_first = less(na + sb + d - 1 - mid, sa + mid)
        active = lo < hi
        hi = torch.where(active & b_first, mid, hi)
        lo = torch.where(active & ~b_first, mid + 1, lo)
    j = d - lo
    take_b = (j < cb) & ((lo >= ca) | less(na + sb + j, sa + lo))
    src = torch.where(take_b, na + sb + j, sa + lo)
    return torch.cat([data_a, data_b], dim=1)[:, src[d < ca + cb]]


def runmerge(cmp_a: torch.Tensor, cmp_b: torch.Tensor, data_a: torch.Tensor,
             data_b: torch.Tensor, starts: torch.Tensor, codes: Sequence[int],
             block: int) -> torch.Tensor:
    """Merge sorted runs a and b, stacked ``(lanes, n)`` int32: ``cmp_*``
    their compare lanes, ``data_*`` the lanes to merge, ``starts`` the
    diagonal split of :func:`merge_path_starts` (int32), ``codes`` the
    compare lanes' codes (:func:`cmp_codes`). Returns the merged ``(n_arr,
    na + nb)`` int32 data lanes. A CPU tensor runs the plain version; a
    CUDA tensor launches the kernel."""
    n_cmp, na = cmp_a.shape
    n_arr, nb = data_a.shape[0], cmp_b.shape[1]
    for t, rows, n in ((cmp_a, n_cmp, na), (cmp_b, n_cmp, nb),
                       (data_a, n_arr, na), (data_b, n_arr, nb)):
        if (t.dtype != torch.int32 or not t.is_contiguous()
                or tuple(t.shape) != (rows, n)):
            raise ValueError("runmerge: expected contiguous stacked int32 "
                             f"runs, got {tuple(t.shape)} {t.dtype}")
    if len(codes) != n_cmp or n_cmp > MAX_CMP_LANES:
        raise ValueError(f"runmerge: need 1 to {MAX_CMP_LANES} compare lanes "
                         "and a code each")
    if na + nb >= _INDEX_FILL:
        raise ValueError("runmerge: runs of 2^31 - 1 elements or more")
    nblocks = starts.shape[1] - 1
    if nblocks * block < na + nb:
        raise ValueError("runmerge: the split does not cover the runs")
    if cmp_a.device.type == "cpu":
        return runmerge_plain(cmp_a, cmp_b, data_a, data_b, starts, codes,
                              block)
    if starts.dtype != torch.int32 or not starts.is_contiguous():
        raise ValueError("runmerge: the split must be contiguous int32")
    out = torch.empty((n_arr, na + nb), dtype=torch.int32,
                      device=cmp_a.device)
    KERNEL(cmp_a.device, cmp_a.data_ptr(), cmp_b.data_ptr(),
           data_a.data_ptr(), data_b.data_ptr(), out.data_ptr(),
           starts.data_ptr(), n_cmp, n_arr, codes_mask(codes), na, nb,
           nblocks, block)
    return out


def merge_operands(a_lanes, b_lanes, n_cmp: int | None = None,
                   max_values=None, block: int = DEFAULT_MERGE_BLOCK):
    """The arguments of :func:`runmerge` but ``block`` for two sorted runs:
    ``(cmp_a, cmp_b, data_a, data_b, starts, codes)``."""
    if n_cmp is None:
        cmp_a = packed_cmp_lanes(a_lanes, max_values)
        cmp_b = packed_cmp_lanes(b_lanes, max_values)
    else:
        cmp_a, cmp_b = a_lanes[:n_cmp], b_lanes[:n_cmp]
    codes = cmp_codes(cmp_a)
    data_a, data_b = stack_lanes(a_lanes), stack_lanes(b_lanes)
    if n_cmp is None:
        sa, sb = stack_lanes(cmp_a), stack_lanes(cmp_b)
    else:
        sa, sb = data_a[:n_cmp], data_b[:n_cmp]
    starts = merge_path_starts(sa, sb, block, codes)
    return sa, sb, data_a, data_b, starts, codes


def merge_runs_lex_kernel(a_lanes, b_lanes, n_cmp: int | None = None,
                          max_values=None, block: int | None = None):
    """Merge two sorted lex-tuple runs (tuples of parallel 1-D 32-bit
    tensors, any lengths) with the block-parallel merge-path kernel — the
    counterpart of ``merge_runs_lex_pallas``. ``n_cmp``: the leading
    ``n_cmp`` lanes are the compare list as they are; ``None`` packs rank
    keys from all lanes (``keypack.packed_cmp_lanes``). ``block``: a power
    of two >= 128 (default 256). Returns the tuple of merged lanes."""
    a_lanes, b_lanes = check_runs([a_lanes, b_lanes])
    block = check_block(DEFAULT_MERGE_BLOCK if block is None else block)
    if a_lanes[0].shape[0] == 0:
        return b_lanes
    if b_lanes[0].shape[0] == 0:
        return a_lanes
    out = runmerge(*merge_operands(a_lanes, b_lanes, n_cmp, max_values,
                                   block), block)
    return tuple(from_bits(out[l], a.dtype) for l, a in enumerate(a_lanes))
