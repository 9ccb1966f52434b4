"""B7: splitter partition — each key's bucket id against a splitter list and
every row's bucket histogram — as a hand-written CUDA kernel
(``csrc/partition.cu``) and its plain PyTorch version; the counterpart of
``repro.kernels.partition_kernel``.

Both take keys ``(R, C)`` and splitters ``(S,)``, signed int32, and return
``bucket_ids[r, c] = #{j : keys[r, c] >= splitters[j]}`` and ``counts[r, p]
= #{c : bucket_ids[r, c] == p}`` for ``p`` in ``[0, S]``, both int32. The id
is a count, as in the TPU kernel. It does not depend on the splitters'
order: it equals ``searchsorted(side='right')`` over the splitters sorted
first, for any list, and over the list itself only when that is sorted.
Nothing is padded.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import SMEM_LIMIT, Kernel

__all__ = ["KERNEL", "MAX_SPLITTERS", "partition_rows",
           "partition_rows_plain"]

KERNEL = Kernel("partition_rows", "partition.cu", "partition_rows",
                [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3,
                replaces="src/repro/kernels/partition_kernel.py:24")

# a block holds the S splitters and its S + 1 histogram bins in shared
# memory, 4 bytes each
MAX_SPLITTERS = (SMEM_LIMIT // 4 - 1) // 2


def partition_rows_plain(x: torch.Tensor, splitters: torch.Tensor):
    """The plain version: the TPU kernel's arithmetic — one compare and
    accumulate over the whole tensor per splitter, then one masked sum per
    bucket. Returns ``(bucket_ids, counts)``."""
    bucket = torch.zeros(x.shape, dtype=torch.int32, device=x.device)
    for j in range(splitters.shape[0]):
        bucket += (x >= splitters[j]).to(torch.int32)
    counts = torch.stack([(bucket == p).sum(dim=1, dtype=torch.int32)
                          for p in range(splitters.shape[0] + 1)], dim=1)
    return bucket, counts


def partition_rows(x: torch.Tensor, splitters: torch.Tensor):
    """Bucket ids ``(R, C)`` and histograms ``(R, S + 1)`` of contiguous
    int32 keys ``x`` ``(R, C)`` against contiguous int32 ``splitters``
    ``(S,)``, any order, duplicates allowed. A CPU tensor runs the plain
    version; a CUDA tensor launches the kernel. More than
    :data:`MAX_SPLITTERS` splitters raise ``ValueError``."""
    if (x.dtype != torch.int32 or x.dim() != 2 or not x.is_contiguous()
            or splitters.dtype != torch.int32 or splitters.dim() != 1
            or not splitters.is_contiguous()):
        raise ValueError("partition_rows: expected contiguous (rows, cols) "
                         "int32 keys and (splitters,) int32 splitters, got "
                         f"{tuple(x.shape)} {x.dtype} and "
                         f"{tuple(splitters.shape)} {splitters.dtype}")
    if x.device != splitters.device:
        raise ValueError("partition_rows: keys and splitters lie on "
                         f"{x.device} and {splitters.device}")
    n_spl = splitters.shape[0]
    if n_spl > MAX_SPLITTERS:
        raise ValueError(f"partition_rows: {n_spl} splitters; a block's "
                         f"{SMEM_LIMIT}-byte shared memory holds at most "
                         f"{MAX_SPLITTERS} with their histogram")
    if x.device.type == "cpu":
        return partition_rows_plain(x, splitters)
    if x.device.type != "cuda":
        raise ValueError(f"partition_rows: no kernel for device {x.device}")
    rows, cols = x.shape
    bid = torch.empty((rows, cols), dtype=torch.int32, device=x.device)
    counts = torch.zeros((rows, n_spl + 1), dtype=torch.int32,
                         device=x.device)
    KERNEL(x.device, x.data_ptr(), splitters.data_ptr(), bid.data_ptr(),
           counts.data_ptr(), rows, cols, n_spl)
    return bid, counts
