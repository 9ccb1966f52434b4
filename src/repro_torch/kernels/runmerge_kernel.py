"""B5: merge-path combine of two sorted runs, one output block at a time —
a hand-written CUDA kernel (``csrc/runmerge.cu``) and its plain PyTorch
version; the counterpart of ``repro.kernels.runmerge_kernel``.

  1. **Diagonal split** (torch glue, :func:`merge_path_starts`): the
     merge-path ranks of run ``a`` against run ``b`` come from
     ``keypack.lex_searchsorted`` on the compare lanes (a before b on ties),
     and one ``torch.searchsorted`` over those ranks gives, for every output
     block of ``block`` slots, the segments ``a[sa:ea)`` and ``b[sb:eb)``
     with ``(ea - sa) + (eb - sb) == block``.
  2. **Per-block merge** (:func:`runmerge`): the segments' compare lanes and
     an int32 source-index lane go into a ``2 * block`` window, the tails
     filled with the sentinel tuple; B4's network (``merge_kernel``) merges
     it, and every data lane of the low ``block`` slots is copied from its
     source index.

The window holds the compare lanes only, never the whole tuple (the
pipeline's tuples are 10-18 arrays): the compare prefix is an
order-preserving refinement of the tuple — equal prefix, equal tuple — and
the index orders the remaining ties a before b and in run order, so the
result is the stable merge, bit for bit that of
``keypack.merge_take_packed``, on every lane type.

Runs travel stacked: ``(lanes, n)`` int32 bit views, the compare lanes in
their own stack (or the leading rows of the data stack).
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from ._build import Kernel
from .keypack import lex_searchsorted, packed_cmp_lanes
from .lex import I32, as_bits, codes_mask, dtype_code, from_bits, \
    sentinel_bits
from .merge_kernel import merge_network_plain

__all__ = ["KERNEL", "DEFAULT_MERGE_BLOCK", "MAX_CMP_LANES",
           "merge_path_starts", "merge_operands", "runmerge",
           "runmerge_plain", "merge_runs_lex_kernel", "stack_lanes",
           "check_block", "check_runs", "window_codes"]

KERNEL = Kernel("merge_runs_lex", "runmerge.cu", "runmerge_lex",
                [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_int,
                                         ctypes.c_uint] + [ctypes.c_int] * 4,
                replaces="src/repro/kernels/runmerge_kernel.py:54")

# one output block per CTA: the reference's tile
DEFAULT_MERGE_BLOCK = 256
# compare lanes a window takes: with the index lane, 16 two-bit codes fill
# the kernels' 32-bit codes argument
MAX_CMP_LANES = 15
_INDEX_FILL = (1 << 31) - 1


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


def window_codes(cmp_lanes) -> list:
    """The codes of a merge window: the compare lanes', then the index
    lane's."""
    codes = [dtype_code(a.dtype) for a in cmp_lanes] + [I32]
    if len(codes) > MAX_CMP_LANES + 1:
        raise ValueError(f"at most {MAX_CMP_LANES} compare lanes, got "
                         f"{len(codes) - 1}")
    return codes


def merge_path_starts(cmp_a, cmp_b, block: int) -> torch.Tensor:
    """The diagonal split: ``(2, nblocks + 1)`` int32, row 0 the start of
    each output block's a-segment, row 1 its b-segment's, for sorted runs
    with compare lanes ``cmp_a`` and ``cmp_b`` (a before b on ties)."""
    na, nb = cmp_a[0].shape[0], cmp_b[0].shape[0]
    dev = cmp_a[0].device
    nblocks = -(-(na + nb) // block)
    rank_a = torch.arange(na, device=dev) + lex_searchsorted(
        cmp_b, cmp_a, side="left")
    bounds = torch.arange(nblocks + 1, device=dev) * block
    a_starts = torch.searchsorted(rank_a, bounds, side="left")
    b_starts = (bounds - a_starts).clamp(0, nb)
    return torch.stack([a_starts, b_starts]).to(torch.int32)


def runmerge_plain(cmp_a, cmp_b, data_a, data_b, starts, codes: Sequence[int],
                   block: int) -> torch.Tensor:
    """The plain version: every block's window built with gathers and run
    through B4's network (``merge_kernel.merge_network_plain``), then the
    data lanes gathered by the merged index lane. Returns ``(n_arr, na +
    nb)`` int32."""
    n_cmp, na = cmp_a.shape
    nb = cmp_b.shape[1]
    dev = cmp_a.device
    nblocks = starts.shape[1] - 1
    col = torch.arange(block, device=dev)
    s = starts.to(torch.int64)

    def half(cmp, bounds, base):
        pos = bounds[:-1, None] + col                  # (nblocks, block)
        valid = pos < bounds[1:, None]
        src = pos.clamp(max=max(cmp.shape[1] - 1, 0))
        lanes = [torch.where(valid, cmp[l][src] if cmp.shape[1] else 0,
                             sentinel_bits(codes[l])) for l in range(n_cmp)]
        idx = torch.where(valid, pos + base, _INDEX_FILL).to(torch.int32)
        return torch.stack(lanes + [idx])

    window = torch.cat([half(cmp_a, s[0], 0), half(cmp_b, s[1], na)], dim=2)
    merged = merge_network_plain(window, codes, block)
    idx = merged[n_cmp, :, :block].reshape(-1)[:na + nb].to(torch.int64)
    return torch.cat([data_a, data_b], dim=1)[:, idx]


def runmerge(cmp_a: torch.Tensor, cmp_b: torch.Tensor, data_a: torch.Tensor,
             data_b: torch.Tensor, starts: torch.Tensor, codes: Sequence[int],
             block: int) -> torch.Tensor:
    """Merge sorted runs a and b, stacked ``(lanes, n)`` int32: ``cmp_*``
    their compare lanes, ``data_*`` the lanes to merge, ``starts`` the
    diagonal split of :func:`merge_path_starts`, ``codes`` the window's
    codes (:func:`window_codes`). Returns the merged ``(n_arr, na + nb)``
    int32 data lanes. A CPU tensor runs the plain version; a CUDA tensor
    launches the kernel."""
    n_cmp, na = cmp_a.shape
    n_arr, nb = data_a.shape[0], cmp_b.shape[1]
    for t, rows, n in ((cmp_a, n_cmp, na), (cmp_b, n_cmp, nb),
                       (data_a, n_arr, na), (data_b, n_arr, nb)):
        if (t.dtype != torch.int32 or not t.is_contiguous()
                or tuple(t.shape) != (rows, n)):
            raise ValueError("runmerge: expected contiguous stacked int32 "
                             f"runs, got {tuple(t.shape)} {t.dtype}")
    if len(codes) != n_cmp + 1 or n_cmp > MAX_CMP_LANES:
        raise ValueError(f"runmerge: need 1 to {MAX_CMP_LANES} compare lanes "
                         f"and a code each plus the index lane's")
    if na + nb >= _INDEX_FILL:
        raise ValueError("runmerge: runs of 2^31 - 1 elements or more")
    nblocks = starts.shape[1] - 1
    if nblocks * block < na + nb:
        raise ValueError("runmerge: the split does not cover the runs")
    if cmp_a.device.type == "cpu":
        return runmerge_plain(cmp_a, cmp_b, data_a, data_b, starts, codes,
                              block)
    out = torch.empty((n_arr, na + nb), dtype=torch.int32,
                      device=cmp_a.device)
    starts = starts.to(torch.int32).contiguous()
    KERNEL(cmp_a.device, cmp_a.data_ptr(), cmp_b.data_ptr(),
           data_a.data_ptr(), data_b.data_ptr(), out.data_ptr(),
           starts.data_ptr(), n_cmp, n_arr, codes_mask(codes), na, nb,
           nblocks, block)
    return out


def merge_operands(a_lanes, b_lanes, n_cmp: int | None = None,
                   max_values=None, block: int = DEFAULT_MERGE_BLOCK):
    """The arguments of :func:`runmerge` but ``block`` for two non-empty
    sorted runs: ``(cmp_a, cmp_b, data_a, data_b, starts, codes)``."""
    if n_cmp is None:
        cmp_a = packed_cmp_lanes(a_lanes, max_values)
        cmp_b = packed_cmp_lanes(b_lanes, max_values)
    else:
        cmp_a, cmp_b = a_lanes[:n_cmp], b_lanes[:n_cmp]
    codes = window_codes(cmp_a)
    starts = merge_path_starts(cmp_a, cmp_b, block)
    data_a, data_b = stack_lanes(a_lanes), stack_lanes(b_lanes)
    if n_cmp is None:
        sa, sb = stack_lanes(cmp_a), stack_lanes(cmp_b)
    else:
        sa, sb = data_a[:n_cmp], data_b[:n_cmp]
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
