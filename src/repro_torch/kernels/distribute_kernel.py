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
kernel takes the cross-tile prefix in its one launch by a decoupled
look-back (see its source).
"""

from __future__ import annotations

import ctypes

import torch

from ._build import Kernel

__all__ = ["KERNEL", "distribute_rows", "distribute_rows_plain", "TILE",
           "buffer_layout"]

KERNEL = Kernel("distribute_rows", "distribute.cu", "distribute_rows",
                [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                 ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                 ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong],
                replaces="src/repro/kernels/distribute_kernel.py:44")

# the fewest words of a CUDA block's tile (DIST_THREADS in
# csrc/distribute.cu), which sets the most tiles the scratch must hold
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
    at, scratch_words = buffer_layout(n, num_buckets)
    buf = torch.empty(at + scratch_words, dtype=torch.int32,
                      device=keys.device)
    base = buf.data_ptr()
    KERNEL(keys.device, keys.data_ptr(), lanes, n, n_valid, num_buckets,
           base, base + 4 * n, base + 8 * n, base + 4 * at, 4 * scratch_words)
    return buf[:n], buf[n:2 * n], buf[2 * n:2 * n + num_buckets]


def buffer_layout(n: int, num_buckets: int) -> tuple[int, int]:
    """The kernel's outputs and scratch share one int32 buffer: ``dest``,
    ``rank`` and ``counts``, then, from an even word, the scratch — its
    ticket and a 64-bit status word per tile and bucket. Returns the word
    where the scratch starts and its length in words."""
    return ((2 * n + num_buckets + 1) // 2 * 2,
            2 * (1 + -(-n // TILE) * num_buckets))
