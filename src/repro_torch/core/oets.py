"""Odd-even transposition sort (OETS) — the parallel formulation of bubble
sort, as a network of torch ops: the counterpart of ``repro.core.oets``.

The paper parallelises bubble sort across length buckets and keeps the
in-bucket sort a serial compare-swap chain. Its parallel-time form is the
same comparator network run as n alternating phases, each ~n/2 independent
neighbour compare-exchanges: one vectorised torch op a phase, all pairs at
once. It is a traced network, not a library sort and not a kernel (the
kernel form is B1, ``kernels/oets_kernel.py``).

Keys are ``(n,)`` of any lane dtype or ``(n, L)`` unsigned multi-lane keys
compared lane-lexicographically, lane 0 most significant. Each phase
compares *order keys* (``kernels.lex.order_view``: float lanes in the
canonical total order, NaN above ``+inf``, ``-0.0 == +0.0``) and moves the
*raw int32 bits*, so every output is a bit-level permutation of its input
and order-equal elements stay where the reference's network leaves them:
a swap happens only on strictly greater, so the sort is stable. torch has
little CUDA support for ``torch.uint32``, so nothing here indexes or
compares a uint32 tensor.
"""

from __future__ import annotations

import torch

from ..kernels.lex import (as_bits, from_bits, lex_gt_keys, order_view,
                           pad_bits)

__all__ = ["lex_gt", "oets_sort", "oets_sort_kv", "oets_argsort"]


def _is_multilane(x: torch.Tensor) -> bool:
    # multi-lane keys are 2-D+ unsigned integer tensors, lanes last
    return x.dim() >= 2 and not x.dtype.is_signed \
        and not x.dtype.is_floating_point


def _order(bits: torch.Tensor, dtype, multilane: bool) -> torch.Tensor:
    """Stacked order keys ``(L, ...)`` from the int32 bits of keys ``(...)``
    of ``dtype``, or of multi-lane keys ``(..., L)``."""
    if multilane:
        return torch.stack([order_view(from_bits(bits[..., l], dtype))
                            for l in range(bits.shape[-1])])
    return order_view(from_bits(bits, dtype))[None]


def lex_gt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Lane-lexicographic ``a > b`` under the canonical total order of
    ``kernels/lex.py``. ``a``/``b``: ``(..., L)`` unsigned multi-lane keys
    or same-shape scalars of any lane dtype. Returns bool ``(...)``."""
    multi = a.dim() == b.dim() and _is_multilane(a)
    return lex_gt_keys(_order(as_bits(a), a.dtype, multi),
                       _order(as_bits(b), b.dtype, multi))


def _exchange(order, moves, lo: slice, hi: slice):
    """Compare-exchange the pairs ``(lo[i], hi[i])`` along the last axis of
    ``order`` ``(L, B, n)`` and the second axis of each ``moves`` tensor
    ``(B, n, ...)``, in place: the pair swaps where ``lo > hi``."""
    ol, oh = order[..., lo], order[..., hi]
    swap = lex_gt_keys(ol, oh)                              # (B, m)
    order[..., lo], order[..., hi] = (torch.where(swap, oh, ol),
                                      torch.where(swap, ol, oh))
    for m in moves:
        ml, mh = m[:, lo], m[:, hi]
        s = swap.reshape(swap.shape + (1,) * (m.dim() - 2))
        m[:, lo], m[:, hi] = torch.where(s, mh, ml), torch.where(s, ml, mh)


def _network(order, moves, iters: int):
    """``iters`` rounds of an even phase (pairs (0,1), (2,3), ...) and an
    odd phase (pairs (1,2), ..., (n-3,n-2)) over an even length n."""
    n = order.shape[-1]
    even = (slice(0, n, 2), slice(1, n, 2))
    odd = (slice(1, n - 2, 2), slice(2, n - 1, 2))
    for _ in range(iters):
        _exchange(order, moves, *even)
        if n > 2:
            _exchange(order, moves, *odd)


def _oets_batched(keys, vals, num_phases=None):
    """OETS along axis 1 of ``keys`` ``(B, n)`` or multi-lane ``(B, n, L)``
    (``vals`` ``(B, n, ...)`` or None): every row sorts independently, the
    reference's network mapped over the leading axis."""
    n_orig = keys.shape[1]
    if n_orig <= 1:
        return keys, vals
    kbits = as_bits(keys).clone()
    vbits = None if vals is None else as_bits(vals).clone()
    if n_orig % 2:
        # an odd length pads one sentinel key and a zero value; it sorts
        # last and is sliced off (``repro/core/oets.py:105-113``)
        pad = kbits.new_full(kbits[:, :1].shape, pad_bits(keys.dtype))
        kbits = torch.cat([kbits, pad], 1)
        if vbits is not None:
            vbits = torch.cat([vbits, torch.zeros_like(vbits[:, :1])], 1)
    n = kbits.shape[1]
    # a copy: an int32 lane's order keys are its bits, which move apart
    order = _order(kbits, keys.dtype, keys.dim() == 3).clone()
    # one round is an even and an odd phase: ceil(n/2) rounds are the full
    # n phases; a truncated network runs ceil(num_phases/2) rounds
    iters = (n + 1) // 2 if num_phases is None else (num_phases + 1) // 2
    moves = [kbits] + ([] if vbits is None else [vbits])
    _network(order, moves, iters)
    out_k = from_bits(kbits[:, :n_orig].contiguous(), keys.dtype)
    if vbits is None:
        return out_k, None
    return out_k, from_bits(vbits[:, :n_orig].contiguous(), vals.dtype)


def _oets(keys, vals, num_phases=None):
    k, v = _oets_batched(keys[None], None if vals is None else vals[None],
                         num_phases)
    return k[0], None if v is None else v[0]


def _check(keys: torch.Tensor, lead: int):
    if keys.dim() == lead + 1 or (keys.dim() == lead + 2
                                  and _is_multilane(keys)):
        return
    raise TypeError("keys must be (n,) or (n, L) unsigned multi-lane keys")


def oets_sort(keys: torch.Tensor, num_phases: int | None = None):
    """Sort ascending along axis 0 by odd-even transposition. ``keys``:
    ``(n,)`` of any lane dtype, or ``(n, L)`` unsigned multi-lane keys.
    ``num_phases`` runs a truncated network (partial sorting experiments);
    the default n phases sort fully."""
    _check(keys, 0)
    out, _ = _oets(keys, None, num_phases)
    return out


def oets_sort_kv(keys: torch.Tensor, vals: torch.Tensor,
                 num_phases: int | None = None):
    """Sort ``keys`` ascending, carrying ``vals`` through the permutation;
    returns ``(keys, vals)``. Stable: equal keys keep their order."""
    if vals.shape[0] != keys.shape[0]:
        raise ValueError("keys/vals leading dims differ")
    _check(keys, 0)
    return _oets(keys, vals, num_phases)


def oets_argsort(keys: torch.Tensor, num_phases: int | None = None):
    """The int32 permutation that sorts ``keys`` (equal keys keep their
    order)."""
    _check(keys, 0)
    idx = torch.arange(keys.shape[0], dtype=torch.int32, device=keys.device)
    _, perm = _oets(keys, idx, num_phases)
    return perm


def oets_sort_rows(keys: torch.Tensor) -> torch.Tensor:
    """:func:`oets_sort` of every row of ``keys`` ``(B, n[, L])`` at once —
    ``jax.vmap(oets_sort)`` of the reference."""
    _check(keys, 1)
    out, _ = _oets_batched(keys, None)
    return out
