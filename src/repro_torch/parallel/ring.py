"""Ring collectives built from :func:`compat.ppermute` — the counterpart of
``repro.parallel.ring``: the explicit-schedule variant of a sum over the
ranks, used where the backend's own all-reduce must be overlapped by hand
(interleaving gradient reduction with the backward pass).

A reduce-scatter (P-1 steps) then an all-gather (P-1 steps) around the
ring: each step moves 1/P of the buffer to the next rank, so every link
carries the same load. Each rank calls these with its own ``x``; ``group``
is the axis (a ``ProcessGroup``, ``None`` the world).
"""

from __future__ import annotations

import torch

from .compat import axis_index, axis_size, ppermute

__all__ = ["ring_all_reduce", "ring_all_gather"]


def ring_all_reduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of every rank's ``x`` (``lax.psum``), by a reduce-scatter and
    an all-gather around the ring. ``x.numel()`` must divide by the ring's
    size."""
    n = axis_size(group)
    if n == 1:
        return x
    me = axis_index(group)
    if x.numel() % n:
        raise ValueError(f"buffer size {x.numel()} not divisible by ring "
                         f"size {n}")
    chunks = x.reshape(n, -1).clone()
    # reduce-scatter: after P-1 steps, chunk (me+1) % n holds the full sum
    for i in range(1, n):
        recv = ppermute(chunks[(me - i + 1) % n], group)
        idx = (me - i) % n
        chunks[idx] = chunks[idx] + recv
    # all-gather: circulate the completed chunks (rank r finished (r+1) % n)
    for i in range(1, n):
        recv = ppermute(chunks[(me + 2 - i) % n], group)
        chunks[(me + 1 - i) % n] = recv
    return chunks.reshape(x.shape)


def ring_all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``x`` stacked on a new leading axis in rank order, by
    P-1 shifts around the ring."""
    n, me = axis_size(group), axis_index(group)
    out = x.new_zeros((n,) + tuple(x.shape))
    out[me] = x
    buf = x
    for i in range(1, n):
        buf = ppermute(buf, group)
        out[(me - i) % n] = buf
    return out
