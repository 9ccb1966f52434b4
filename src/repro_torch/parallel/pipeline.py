"""Pipeline parallelism over a mesh axis — the counterpart of
``repro.parallel.pipeline``.

The GPipe forward schedule: P stages live on the P ranks of an axis;
microbatches stream through, the activations hopping one stage a tick, so
M microbatches finish in M + P - 1 ticks (bubble fraction (P-1)/(M+P-1)).
The hop is the reference's chain ``i -> i+1``: :func:`compat.ppermute` is a
ring shift, so stage 0 drops what the last stage sends it and takes zeros,
as the chain gives it. ``stage_fn`` is any per-stage closure (half a layer
stack, say).
"""

from __future__ import annotations

import torch

from .compat import axis_index, axis_size, ppermute

__all__ = ["pipeline_forward"]


def pipeline_forward(stage_fn, stage_params, x_all: torch.Tensor,
                     group=None) -> torch.Tensor:
    """Run microbatches through the P stages of ``group``'s ranks.

    stage_fn: ``(stage_params, x) -> y`` of the same shape (stages must
    keep the shape, as transformer stacks do).
    stage_params: this rank's stage parameters.
    x_all: ``(M, ...)`` every microbatch (read on stage 0).
    Returns ``(M, ...)`` outputs (meaningful on the last stage; zeros
    elsewhere)."""
    n, me = axis_size(group), axis_index(group)
    m = x_all.shape[0]
    buf = torch.zeros_like(x_all[0])
    outs = torch.zeros_like(x_all)
    for t in range(m + n - 1):
        # stage 0 injects microbatch t
        cur = x_all[t] if me == 0 and t < m else buf
        y = stage_fn(stage_params, cur)
        # the last stage retires microbatch t - (n-1)
        if me == n - 1 and t >= n - 1:
            outs[t - (n - 1)] = y
        # activations hop to the next stage; nothing reaches stage 0
        buf = ppermute(y, group)
        if me == 0:
            buf = torch.zeros_like(buf)
    return outs
