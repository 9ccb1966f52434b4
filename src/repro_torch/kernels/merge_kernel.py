"""B4: merge of adjacent sorted blocks — blocksort's cross-block round — as
a hand-written CUDA kernel (``csrc/merge.cu``) and its plain PyTorch
version.

Both merge, in every row of a stacked ``(A, R, N)`` int32 lane tensor (see
``kernels/lex.py``), the ``npairs`` pairs of sorted ``block``-wide blocks
that start at column ``lo``: a reflected compare-exchange (partner
``2B-1-i``) splits each pair into two bitonic halves, then ``log2 B`` XOR
steps finish them, the low half left — ``repro.kernels.merge_kernel``'s
``_merge_network``, so all three agree bit for bit. The port merges in place
at an offset where the reference slices and concatenates (``core/blocksort``).
The kernel runs the near stages of the network in registers (inside a
thread, or across a group of a warp's lanes by shuffles) and the far ones
through shared memory, which holds the whole pair window and so sets
:func:`max_merge_block`.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from ._build import SMEM_LIMIT, Kernel, check_stacked
from .bitonic_kernel import xor_stage
from .lex import lex_gt_keys, order_keys

__all__ = ["KERNEL", "merge_adjacent_lex", "merge_network_plain",
           "max_merge_block"]

KERNEL = Kernel("merge_adjacent_lex", "merge.cu", "merge_adjacent_lex",
                [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                 ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_uint],
                replaces="src/repro/kernels/merge_kernel.py:74")


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
