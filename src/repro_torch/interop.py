"""Carrying state between the reference package and the port.

The sort has no weights: what crosses between the two packages is data —
packed keys ``(n, lanes)``, a bucket tensor ``(num_buckets, capacity,
lanes)`` and its counts — as numpy arrays on the reference's side and torch
tensors on the port's. ``uint32`` arrays become ``torch.uint32`` tensors
with the same bits (moved as int32 views, since torch's uint32 support is
thin) and come back as ``numpy.uint32``.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["resolve_device", "to_device", "to_numpy"]


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises if it names CUDA and no card
    is present — the port never drops to the CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the kernels' plain versions")
    return dev


def to_device(x, device="cuda"):
    """A numpy array or torch tensor — or a tuple or list of them — as
    torch tensors on ``device``, bits unchanged."""
    if isinstance(x, (tuple, list)):
        return type(x)(to_device(a, device) for a in x)
    dev = resolve_device(device)
    if isinstance(x, torch.Tensor):
        t = x
    else:
        a = np.ascontiguousarray(x)
        t = torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)
        if a.dtype == np.uint32:
            t = t.view(torch.uint32)
    if t.dtype == torch.uint32:
        return t.view(torch.int32).to(dev).view(torch.uint32)
    return t.to(dev)


def to_numpy(x):
    """A torch tensor — or a tuple or list of them — as numpy arrays on the
    host, bits unchanged (``torch.uint32`` becomes ``numpy.uint32``)."""
    if isinstance(x, (tuple, list)):
        return type(x)(to_numpy(t) for t in x)
    if x.dtype == torch.uint32:
        return x.view(torch.int32).cpu().numpy().view(np.uint32)
    return x.cpu().numpy()
