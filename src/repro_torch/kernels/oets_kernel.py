"""B1: odd-even transposition sort of every row — the paper's parallel
bubble sort — as a hand-written CUDA kernel (``csrc/oets.cu``) and its plain
PyTorch version.

Both sort each row of a stacked ``(A, R, C)`` int32 lane tensor (see
``kernels/lex.py``) by full-tuple lexicographic compare: C phases, phase p
compare-exchanging the pairs ``(i, i+1)`` with ``i = p mod 2`` — the network
of ``repro.kernels.oets_kernel`` (partners from two rolls and parity masks),
so all three agree bit for bit. The caller pads (``ops.sort_rows_lex``).
On the card, rows of up to 128 columns (every row of the OETS tier) sort
one warp a row in registers and shuffles, wider rows one block a row in
shared memory.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from ._build import SMEM_LIMIT, Kernel, check_stacked
from .lex import lex_gt_keys, order_keys

__all__ = ["KERNEL", "oets_rows_lex", "oets_rows_lex_plain"]

KERNEL = Kernel("oets_rows_lex", "oets.cu", "oets_rows_lex",
                [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                 ctypes.c_uint],
                replaces="src/repro/kernels/oets_kernel.py:38")


def oets_rows_lex_plain(x: torch.Tensor, codes: Sequence[int]) -> torch.Tensor:
    """The plain version: the same network as roll/where passes over the
    whole tensor. Returns the sorted tensor."""
    n_arr, ncols = x.shape[0], x.shape[-1]
    z = torch.cat([x, order_keys(x, codes)])      # raw bits, then order keys
    col = torch.arange(ncols, device=x.device)
    for p in range(ncols):
        parity = p % 2
        nxt = torch.roll(z, -1, dims=-1)
        prv = torch.roll(z, 1, dims=-1)
        is_left = (col % 2 == parity) & (col < ncols - 1)
        is_right = (col % 2 == 1 - parity) & (col >= 1)
        swap_next = is_left & lex_gt_keys(z[n_arr:], nxt[n_arr:])
        swap_prev = is_right & lex_gt_keys(prv[n_arr:], z[n_arr:])
        z = torch.where(swap_next, nxt, torch.where(swap_prev, prv, z))
    return z[:n_arr]


def oets_rows_lex(x: torch.Tensor, codes: Sequence[int]) -> torch.Tensor:
    """Sort each row of the stacked ``(A, R, C)`` int32 lane tensor ``x`` in
    place and return it. ``codes[a]`` is array ``a``'s lane code. A CPU
    tensor runs the plain version; a CUDA tensor launches the kernel."""
    mask = check_stacked(x, codes, "oets_rows_lex")
    if x.device.type == "cpu":
        return x.copy_(oets_rows_lex_plain(x, codes))
    n_arr, rows, cols = x.shape
    if n_arr * cols * 4 > SMEM_LIMIT:
        raise ValueError(f"oets_rows_lex: a row of {n_arr} x {cols} lanes "
                         f"exceeds the {SMEM_LIMIT}-byte shared memory of a "
                         "block")
    KERNEL(x.device, x.data_ptr(), n_arr, rows, cols, mask)
    return x
