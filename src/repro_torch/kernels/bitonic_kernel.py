"""B2: bitonic sorting network over every row, as a hand-written CUDA
kernel (``csrc/bitonic.cu``) and its plain PyTorch version.

Both sort each row of a stacked ``(A, R, C)`` int32 lane tensor (see
``kernels/lex.py``), ``C`` a power of two, by full-tuple lexicographic
compare: the network of ``repro.kernels.bitonic_kernel`` (XOR partner from
two rolls and a bit select, direction from ``col & 2^stage``), so all three
agree bit for bit. The bitonic tier of ``ops.choose_plan`` and blocksort's
local sort. The kernel runs the stages with near partners in registers
(inside a thread, or across a group of a warp's lanes by shuffles) and the
far ones through shared memory, which holds the whole row (see its source).
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from ._build import SMEM_LIMIT, Kernel, check_stacked
from .lex import lex_gt_keys, order_keys

__all__ = ["KERNEL", "bitonic_rows_lex", "bitonic_rows_lex_plain"]

KERNEL = Kernel("bitonic_rows_lex", "bitonic.cu", "bitonic_rows_lex",
                [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                 ctypes.c_uint],
                replaces="src/repro/kernels/bitonic_kernel.py:64")


def xor_stage(z: torch.Tensor, n_arr: int, col: torch.Tensor, j: int,
              asc: torch.Tensor | None = None) -> torch.Tensor:
    """One compare-exchange step over ``z`` (raw bits stacked over their
    order keys, ``n_arr`` of each) with partner ``col ^ j``: ascending where
    ``asc`` is true, everywhere when it is None. Shared with the merge
    network."""
    bit_unset = (col & j) == 0
    partners = torch.where(bit_unset, torch.roll(z, -j, dims=-1),
                           torch.roll(z, j, dims=-1))
    gt = lex_gt_keys(z[n_arr:], partners[n_arr:])
    lt = lex_gt_keys(partners[n_arr:], z[n_arr:])
    swap = torch.where(bit_unset, gt, lt)
    if asc is not None:
        swap = torch.where(asc, swap, torch.where(bit_unset, lt, gt))
    return torch.where(swap, partners, z)


def bitonic_rows_lex_plain(x: torch.Tensor,
                           codes: Sequence[int]) -> torch.Tensor:
    """The plain version: the same network as roll/where passes over the
    whole tensor. Returns the sorted tensor."""
    n_arr, ncols = x.shape[0], x.shape[-1]
    z = torch.cat([x, order_keys(x, codes)])      # raw bits, then order keys
    col = torch.arange(ncols, device=x.device)
    for stage in range(1, ncols.bit_length()):
        asc = (col & (1 << stage)) == 0
        for sub in reversed(range(stage)):
            z = xor_stage(z, n_arr, col, 1 << sub, asc)
    return z[:n_arr]


def bitonic_rows_lex(x: torch.Tensor, codes: Sequence[int]) -> torch.Tensor:
    """Sort each row of the stacked ``(A, R, C)`` int32 lane tensor ``x``
    (``C`` a power of two) in place and return it. A CPU tensor runs the
    plain version; a CUDA tensor launches the kernel."""
    mask = check_stacked(x, codes, "bitonic_rows_lex")
    n_arr, rows, cols = x.shape
    if cols & (cols - 1):
        raise ValueError("bitonic_rows_lex: cols must be a power of two "
                         "(pad in ops.py)")
    if x.device.type == "cpu":
        return x.copy_(bitonic_rows_lex_plain(x, codes))
    if n_arr * cols * 4 > SMEM_LIMIT:
        raise ValueError(f"bitonic_rows_lex: a row of {n_arr} x {cols} lanes "
                         f"exceeds the {SMEM_LIMIT}-byte shared memory of a "
                         "block")
    KERNEL(x.device, x.data_ptr(), n_arr, rows, cols, mask)
    return x
