"""Global-norm gradient clipping — the counterpart of ``repro.optim.clip``.

A tree here is a dict of tensors (``{name: grad}``); the norm is taken in
float32 and each leaf is scaled in float32 and cast back to its dtype."""

from __future__ import annotations

import torch

__all__ = ["global_norm", "clip_by_global_norm"]


def global_norm(tree) -> torch.Tensor:
    """``sqrt(sum of squares)`` over every leaf, in float32, the leaves'
    sums added in the dict's order."""
    total = None
    for leaf in tree.values():
        s = torch.sum(torch.square(leaf.float()))
        total = s if total is None else total + s
    return torch.sqrt(total)


def clip_by_global_norm(tree, max_norm: float):
    """``(tree scaled by min(1, max_norm / norm), norm)``: a new dict, each
    leaf in its own dtype."""
    g = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(g, min=1e-12), max=1.0)
    return {k: (l.float() * scale).to(l.dtype) for k, l in tree.items()}, g
