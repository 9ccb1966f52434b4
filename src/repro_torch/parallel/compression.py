"""Gradient compression for the cross-pod all-reduce: int8 quantization
with error feedback — the counterpart of ``repro.parallel.compression``.

The cross-pod link is the scarcest in a multi-pod job; 4x compression of
the gradient all-reduce is a standard trick. Error feedback (Karimireddy et
al. 2019) keeps the quantization residual locally and adds it to the next
step's gradient, so the *average* update stays unbiased.

``jnp.round`` and ``torch.round`` both round half to even and the int32
sum is exact, so each function here gives the reference's bits: the eager
ones round ``corrected - q * scale`` twice, as the reference's eager
functions do, and :func:`compressed_psum` once, as its jitted body does.
A tree is a (nested) dict of tensors.
"""

from __future__ import annotations

import torch

from .compat import axis_size, pmax, psum

__all__ = ["quantize_int8", "dequantize_int8", "compressed_psum", "ef_init",
           "ef_compress"]


def _scale(amax: torch.Tensor) -> torch.Tensor:
    return torch.clamp(amax, min=1e-12) / 127.0


def _q8(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def quantize_int8(x: torch.Tensor):
    """Symmetric per-tensor int8. Returns ``(q, scale)``, scale float32."""
    scale = _scale(torch.max(torch.abs(x)))
    return _q8(x, scale), scale.to(torch.float32)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def _map(fn, *trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


def ef_init(tree):
    """A float32 zero residual like each leaf of ``tree``."""
    return _map(lambda l: torch.zeros(l.shape, dtype=torch.float32,
                                      device=l.device), tree)


def ef_compress(grads, residual):
    """Error-feedback compression of a gradient tree. Returns
    ``(tree of (q, scale), new residual)``: the value sent is
    ``dequantize_int8(q, scale)``, the residual what was rounded away."""
    def one(g, r):
        corrected = g.to(torch.float32) + r
        q, s = quantize_int8(corrected)
        return (q, s), corrected - dequantize_int8(q, s)

    pairs = _map(one, grads, residual)
    return _part(pairs, 0), _part(pairs, 1)


def _part(pairs, i):
    """Item ``i`` of each ``(compressed, residual)`` leaf of ``pairs``."""
    if isinstance(pairs, dict):
        return {k: _part(v, i) for k, v in pairs.items()}
    return pairs[i]


def compressed_psum(x: torch.Tensor, group, residual: torch.Tensor):
    """int8-compressed all-reduce with error feedback over ``group``'s
    ranks: one float32 ``pmax`` agrees on a scale, so the int32 sum of the
    quantized values (the wire format a deployment would ship, widened
    against overflow) is exact. Returns ``(mean over the ranks, new
    residual)``."""
    corrected = x.to(torch.float32) + residual
    scale = _scale(pmax(torch.max(torch.abs(corrected)), group))
    q = _q8(corrected, scale)
    # rounded once, as the reference's jitted body rounds it (XLA fuses the
    # multiply and the subtract): the product of an int8 and a float32 is
    # exact in float64, and so, but for a tie, is the difference
    new_residual = (corrected.double() - q.double() * scale.double()).to(
        torch.float32)
    total = psum(q.to(torch.int32), group)
    mean = total.to(torch.float32) * scale / axis_size(group)
    return mean, new_residual
