"""B4: blocksort's cross-block merge as hand-written CUDA kernels
(``csrc/merge.cu``) and their plain PyTorch versions, in two designs.

* **Merge-path rounds** (:func:`merge_pairs_lex`), blocksort's: one launch
  merges every pair of adjacent sorted ``run``-wide runs of every row of a
  stacked ``(A, R, N)`` int32 lane tensor (see ``kernels/lex.py``) into a
  second tensor; a last run with no partner is copied. Every lane compares,
  ties take the left run first: the stable merge, which the plain version
  (:func:`merge_pairs_plain`) gets as a stable sort of each pair window by
  its order keys. Rounds at run ``B, 2B, 4B, ...`` sort a row of ``nb``
  sorted blocks in ``ceil(log2 nb)`` passes (``core/blocksort``), where the
  reference's odd-even block rounds take ``nb``.
* **The reflected network** (:func:`merge_adjacent_lex`), the counterpart of
  the reference's ``merge_adjacent_*_pallas``: in every row, the ``npairs``
  pairs of sorted ``block``-wide blocks that start at column ``lo`` merge in
  place by a reflected compare-exchange (partner ``2B-1-i``) and ``log2 B``
  XOR steps, the low half left — ``repro.kernels.merge_kernel``'s
  ``_merge_network``, so all three agree bit for bit. The kernel runs the
  near stages of the network in registers (inside a thread, or across a
  group of a warp's lanes by shuffles) and the far ones through shared
  memory, which holds the whole pair window and so sets
  :func:`max_merge_block`. No path of the port launches it.

The two agree bit for bit wherever tuples are distinct or bit-equal; float
ties that compare equal but differ in bits (``-0.0`` and ``+0.0``, NaN
payloads) may fall in another order.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from ._build import SMEM_LIMIT, Kernel, check_stacked
from .bitonic_kernel import xor_stage
from .lex import lex_gt_keys, order_keys

__all__ = ["KERNEL", "PAIRS_KERNEL", "merge_adjacent_lex",
           "merge_network_plain", "merge_pairs_lex", "merge_pairs_plain",
           "max_merge_block"]

KERNEL = Kernel("merge_adjacent_lex", "merge.cu", "merge_adjacent_lex",
                [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                 ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_uint],
                replaces="src/repro/kernels/merge_kernel.py:74")
# blocksort's rounds, which the reference runs as nb odd-even rounds of the
# network kernel
PAIRS_KERNEL = Kernel("merge_pairs_lex", "merge.cu", "merge_pairs_lex",
                      [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_uint],
                      replaces="src/repro/core/blocksort.py:90")


def max_merge_block(n_arrays: int) -> int:
    """The widest power-of-two block whose pair window of ``n_arrays``
    arrays (``2 B x n_arrays x 4`` bytes) fits a block's shared memory."""
    return 1 << ((SMEM_LIMIT // (8 * n_arrays)).bit_length() - 1)


def merge_network_plain(x: torch.Tensor, codes: Sequence[int],
                        block: int) -> torch.Tensor:
    """The plain version over ``(A, R, npairs * 2 * block)``: every pair of
    adjacent sorted blocks merged by the same network, as flip/roll/where
    passes. Returns the merged tensor."""
    n_arr = x.shape[0]
    rows, cols = x.shape[1], x.shape[2]
    # one pair per row, so the reflection is one flip
    z = torch.cat([x, order_keys(x, codes)]).reshape(2 * n_arr, -1, 2 * block)
    col = torch.arange(2 * block, device=x.device)
    partners = torch.flip(z, dims=[-1])
    lower = col < block
    swap = torch.where(lower, lex_gt_keys(z[n_arr:], partners[n_arr:]),
                       lex_gt_keys(partners[n_arr:], z[n_arr:]))
    z = torch.where(swap, partners, z)
    j = block // 2
    while j >= 1:
        z = xor_stage(z, n_arr, col, j)
        j //= 2
    return z[:n_arr].reshape(n_arr, rows, cols)


def merge_adjacent_lex(x: torch.Tensor, codes: Sequence[int], *, block: int,
                       lo: int = 0, npairs: int | None = None) -> torch.Tensor:
    """Merge, in place, the ``npairs`` pairs of sorted ``block``-wide blocks
    starting at column ``lo`` of every row of the stacked ``(A, R, N)``
    int32 lane tensor ``x``; ``npairs=None`` takes every whole pair from
    ``lo`` on. Returns ``x``. A CPU tensor runs the plain version; a CUDA
    tensor launches the kernel."""
    mask = check_stacked(x, codes, "merge_adjacent_lex")
    n_arr, rows, ncols = x.shape
    if block < 1 or block & (block - 1):
        raise ValueError("merge_adjacent_lex: block must be a power of two")
    if npairs is None:
        npairs = (ncols - lo) // (2 * block)
    hi = lo + npairs * 2 * block
    if lo < 0 or npairs < 0 or hi > ncols:
        raise ValueError(f"merge_adjacent_lex: pairs [{lo}, {hi}) exceed the "
                         f"{ncols} columns")
    if npairs == 0:
        return x
    if x.device.type == "cpu":
        x[:, :, lo:hi] = merge_network_plain(x[:, :, lo:hi], codes, block)
        return x
    if block > max_merge_block(n_arr):
        raise ValueError(f"merge_adjacent_lex: a pair window of {n_arr} x "
                         f"{2 * block} lanes exceeds the {SMEM_LIMIT}-byte "
                         "shared memory of a block")
    KERNEL(x.device, x.data_ptr(), n_arr, rows, ncols, lo, npairs, block, mask)
    return x


def _stable_windows(x: torch.Tensor, codes: Sequence[int],
                    width: int) -> torch.Tensor:
    """Each ``width``-wide window of every row of ``(A, R, k * width)``
    sorted stably in the lex order of its order keys: a chain of stable
    sorts, the least significant lane first."""
    n_arr = x.shape[0]
    z = x.reshape(n_arr, -1, width)
    keys = order_keys(z, codes)
    perm = None
    for a in reversed(range(n_arr)):
        k = keys[a] if perm is None else keys[a].gather(-1, perm)
        idx = torch.sort(k, dim=-1, stable=True).indices
        perm = idx if perm is None else perm.gather(-1, idx)
    return z.gather(-1, perm.expand(n_arr, -1, -1)).reshape(x.shape)


def merge_pairs_plain(x: torch.Tensor, codes: Sequence[int],
                      run: int) -> torch.Tensor:
    """The plain version of one round over ``(A, R, N)``: every pair window
    of ``2 * run`` columns (the last cut at ``N``) sorted stably by its
    lanes' order keys — for two sorted runs, the stable merge, the left
    run first on ties. Returns a new tensor."""
    ncols = x.shape[2]
    width = 2 * run
    full = ncols // width * width
    out = x.clone()
    if full:
        out[:, :, :full] = _stable_windows(x[:, :, :full], codes, width)
    if ncols - full > run:
        out[:, :, full:] = _stable_windows(x[:, :, full:], codes, ncols - full)
    return out


def merge_pairs_lex(src: torch.Tensor, dst: torch.Tensor,
                    codes: Sequence[int], *, run: int) -> torch.Tensor:
    """Merge every pair of adjacent sorted ``run``-wide runs (``run`` a
    power of two) of every row of the stacked ``(A, R, N)`` int32 lane
    tensor ``src`` into ``dst``, a tensor like it that shares no memory
    with it; a last run with no partner is copied. Returns ``dst``. A CPU
    tensor runs the plain version; a CUDA tensor launches the kernel, once."""
    mask = check_stacked(src, codes, "merge_pairs_lex")
    if (dst.shape != src.shape or dst.dtype != src.dtype
            or dst.device != src.device or not dst.is_contiguous()):
        raise ValueError("merge_pairs_lex: dst must be a contiguous tensor "
                         "of src's shape, dtype and device")
    if run < 1 or run & (run - 1):
        raise ValueError("merge_pairs_lex: run must be a power of two")
    nbytes = src.numel() * 4
    if nbytes == 0:
        return dst
    if abs(src.data_ptr() - dst.data_ptr()) < nbytes:
        raise ValueError("merge_pairs_lex: src and dst overlap; the merge "
                         "runs out of place")
    if src.device.type == "cpu":
        return dst.copy_(merge_pairs_plain(src, codes, run))
    n_arr, rows, ncols = src.shape
    PAIRS_KERNEL(src.device, src.data_ptr(), dst.data_ptr(), n_arr, rows,
                 ncols, run, mask)
    return dst
