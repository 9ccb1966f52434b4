"""Plain PyTorch oracles of the row kernels — the counterpart of
``repro.kernels.ref``, for the tests only; nothing on a path calls them.

Every function works along the *last* axis of a ``(rows, cols)`` tensor,
each row alone.
"""

from __future__ import annotations

import torch

__all__ = ["sort_rows_ref", "sort_rows_kv_ref", "partition_rows_ref"]


def sort_rows_ref(x: torch.Tensor) -> torch.Tensor:
    """Ascending sort along the last axis."""
    return torch.sort(x, dim=-1, stable=True).values


def sort_rows_kv_ref(keys: torch.Tensor, vals: torch.Tensor):
    """Ascending stable sort of ``keys`` along the last axis, ``vals``
    permuted alike: ties keep their original order, so this equals the
    kernels only up to the order of equal keys' values."""
    order = torch.sort(keys, dim=-1, stable=True).indices
    return keys.gather(-1, order), vals.gather(-1, order)


def partition_rows_ref(keys: torch.Tensor, splitters: torch.Tensor):
    """Oracle of the splitter partition for sorted splitters: bucket id =
    ``searchsorted(splitters, key, right=True)`` and each row's histogram
    as a one-hot sum, both int32."""
    spl = splitters.to(torch.int32).contiguous()
    bid = torch.searchsorted(spl, keys.to(torch.int32).reshape(-1),
                             right=True).reshape(keys.shape).to(torch.int32)
    onehot = torch.nn.functional.one_hot(bid.long(), spl.shape[0] + 1)
    return bid, onehot.sum(dim=1).to(torch.int32)
