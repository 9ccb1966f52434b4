"""B3: the paper's distribute phase — every word's byte length (its bucket
id), its stable rank inside that bucket, and the length histogram — as a
hand-written CUDA kernel (``csrc/distribute.cu``) and its plain PyTorch
version.

Both take packed words ``(n, lanes)`` as int32 bits (``core/packing.py``'s
big-endian uint32 lanes) and give what ``repro.kernels.distribute_kernel``
gives: the length is the position of the last non-zero byte (interior NUL
bytes count), ranks are the exact arrival-order ranks, and rows at or past
``n_valid`` are padding (bucket ``num_buckets``, rank 0, counted nowhere).
The reference carries running counts along a sequential TPU grid; the CUDA
kernel takes a cross-block prefix instead (see its source).
"""

from __future__ import annotations

import ctypes

import torch

from ._build import Kernel

__all__ = ["KERNEL", "distribute_rows", "distribute_rows_plain", "TILE"]

KERNEL = Kernel("distribute_rows", "distribute.cu", "distribute_rows",
                [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                 ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                 ctypes.c_void_p, ctypes.c_void_p],
                replaces="src/repro/kernels/distribute_kernel.py:44")

# words per CUDA block of the count and offset passes
TILE = 1024
_MAX_LANES = 8


def distribute_rows_plain(keys: torch.Tensor, n_valid: int):
    """The plain version: byte lengths from shifts and masks, ranks from a
    per-bucket running count (one-hot cumsum). Returns ``(dest, rank,
    counts)`` int32."""
    n, lanes = keys.shape
    num_buckets = 4 * lanes + 1
    pos = torch.arange(4 * lanes, device=keys.device, dtype=torch.int32)
    shifts = (24 - 8 * (pos % 4)).to(torch.int32)
    byte = (keys[:, pos // 4] >> shifts) & 0xFF      # arithmetic shift, masked
    length = torch.where(byte != 0, pos + 1, 0).amax(dim=1)
    valid = torch.arange(n, device=keys.device) < n_valid
    dest = torch.where(valid, length, num_buckets).to(torch.int32)
    onehot = (dest[:, None] == torch.arange(num_buckets + 1,
                                            device=keys.device)).to(torch.int32)
    before = torch.cumsum(onehot, dim=0) - onehot
    rank = torch.where(valid, before.gather(1, dest[:, None].long())[:, 0], 0)
    counts = onehot[:, :num_buckets].sum(dim=0)
    return dest, rank.to(torch.int32), counts.to(torch.int32)


def distribute_rows(keys: torch.Tensor, n_valid: int | None = None):
    """Distribute the packed words ``keys`` ``(n, lanes)`` int32 (1 to 8
    lanes). Returns ``(dest, rank, counts)``: ``dest`` (n,) int32 — the
    byte length, which is the bucket id, or ``num_buckets`` for padding
    rows at or past ``n_valid`` (default ``n``); ``rank`` (n,) int32 — the
    stable slot in the bucket; ``counts`` (num_buckets,) int32 — the length
    histogram, ``num_buckets = 4 * lanes + 1``. A CPU tensor runs the plain
    version; a CUDA tensor launches the kernel."""
    if keys.dtype != torch.int32 or keys.dim() != 2 or not keys.is_contiguous():
        raise ValueError("distribute_rows: expected contiguous (n, lanes) "
                         f"int32 words, got {tuple(keys.shape)} {keys.dtype}")
    n, lanes = keys.shape
    if not 1 <= lanes <= _MAX_LANES:
        raise ValueError(f"distribute_rows: need 1 to {_MAX_LANES} lanes, "
                         f"got {lanes}")
    n_valid = n if n_valid is None else n_valid
    if not 0 <= n_valid <= n:
        raise ValueError(f"distribute_rows: n_valid {n_valid} outside [0, {n}]")
    if keys.device.type == "cpu":
        return distribute_rows_plain(keys, n_valid)
    if keys.device.type != "cuda":
        raise ValueError(f"distribute_rows: no kernel for device {keys.device}")
    num_buckets = 4 * lanes + 1
    dest = torch.empty(n, dtype=torch.int32, device=keys.device)
    rank = torch.empty(n, dtype=torch.int32, device=keys.device)
    counts = torch.empty(num_buckets, dtype=torch.int32, device=keys.device)
    scratch = torch.empty(max(1, -(-n // TILE)) * num_buckets,
                          dtype=torch.int32, device=keys.device)
    KERNEL(keys.device, keys.data_ptr(), lanes, n, n_valid, num_buckets, TILE,
           dest.data_ptr(), rank.data_ptr(), counts.data_ptr(),
           scratch.data_ptr())
    return dest, rank, counts
