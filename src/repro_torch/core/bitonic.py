"""Bitonic sorting network in plain PyTorch — the counterpart of
``repro.core.bitonic``, network for network.

The paper's comparator network (bubble sort, OETS) needs n phases; a
bitonic network sorts in O(log^2 n) phases of the same vectorised
compare-exchange with partner ``i ^ j``. ``bitonic_merge`` and its kv and
lex forms merge two sorted blocks in O(log n) phases: the mesh tier's
odd-even engine merges a block with its neighbour's this way
(``core.distributed``, merge ``'bitonic'``).

The reference computes these networks in jnp, not in a Pallas kernel, so
the port's counterpart is the same network in torch: the second block is
reversed behind the first (ascending ++ descending is bitonic), then
compare-exchange stages run from ``sub = n`` down to 1. Each stage compares
*order keys* (``kernels.lex.order_view``: float lanes in the canonical total
order, ``-0.0 == +0.0``, NaNs above ``+inf``) and moves the *raw bits*, so
every output is a bit-level permutation of its input and order-equal
elements (±0, NaN payloads) land where the reference's network puts them.
It is not B4's network: B4 reflects its upper half, which puts order-equal
tuples in another place.
"""

from __future__ import annotations

import math

import torch

from ..kernels.lex import (as_bits, from_bits, lex_gt_keys, order_view,
                           pad_bits)

__all__ = ["bitonic_sort", "bitonic_sort_kv", "bitonic_merge",
           "bitonic_merge_kv", "bitonic_merge_lex"]


def _order(keys: torch.Tensor) -> torch.Tensor:
    """Order keys of ``(n,)`` keys, or ``(L, n)`` stacked lane keys of
    ``(n, L)`` multi-lane unsigned keys (``repro.core.oets.lex_gt``'s two
    forms: lanes compare lexicographically, lane 0 most significant)."""
    if keys.dim() == 1:
        return order_view(keys)[None]
    if keys.dim() == 2 and not keys.dtype.is_signed \
            and not keys.dtype.is_floating_point:
        return torch.stack([order_view(keys[:, l])
                            for l in range(keys.shape[1])])
    raise TypeError("keys must be (n,) or (n, L) unsigned multi-lane keys")


def _cat(parts, dtype) -> torch.Tensor:
    """Concatenate tensors of ``dtype`` through their int32 bits (torch
    concatenates and flips few ``uint32`` tensors)."""
    return from_bits(torch.cat([_bits(p) for p in parts]), dtype)


def _asc_desc(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a`` followed by ``b`` reversed: two ascending blocks as one
    bitonic sequence."""
    return from_bits(torch.cat([_bits(a), _bits(b).flip(0)]), a.dtype)


def _bits(x: torch.Tensor) -> torch.Tensor:
    """``x``'s int32 bits, on which the networks gather and concatenate
    (torch implements few of those for ``torch.uint32``)."""
    return as_bits(x).contiguous()


def _pad_pow2(keys, vals):
    n = keys.shape[0]
    m = 1 << max(0, (n - 1).bit_length())
    if m == n:
        return keys, vals, n
    pad_k = torch.full((m - n,) + tuple(keys.shape[1:]), pad_bits(keys.dtype),
                       dtype=torch.int32, device=keys.device)
    keys = _cat([keys, from_bits(pad_k, keys.dtype)], keys.dtype)
    if vals is not None:
        pad_v = torch.zeros((m - n,) + tuple(vals.shape[1:]),
                            dtype=torch.int32, device=vals.device)
        vals = _cat([vals, from_bits(pad_v, vals.dtype)], vals.dtype)
    return keys, vals, n


class _Net:
    """A network's state: stacked order keys ``(L, n)`` to compare, and the
    raw bits of the keys and values to move."""

    def __init__(self, keys, vals):
        self.order = _order(keys)
        self.kbits = _bits(keys)
        self.vbits = None if vals is None else _bits(vals)
        self.kdt, self.vdt = keys.dtype, None if vals is None else vals.dtype

    def stage(self, j: int, direction: torch.Tensor):
        """Compare-exchange with partner ``i ^ j``; ascending where
        ``direction`` is True (the lower index keeps the min), descending
        elsewhere."""
        n = self.order.shape[1]
        idx = torch.arange(n, device=self.order.device)
        partner = idx ^ j
        pk = self.order[:, partner]
        gt = lex_gt_keys(self.order, pk)
        lt = lex_gt_keys(pk, self.order)
        is_lower = idx < partner
        want_swap = torch.where(direction, torch.where(is_lower, gt, lt),
                                torch.where(is_lower, lt, gt))
        self.order = torch.where(want_swap, pk, self.order)
        self.kbits = _swap(self.kbits, partner, want_swap)
        if self.vbits is not None:
            self.vbits = _swap(self.vbits, partner, want_swap)

    def result(self, n: int):
        keys = from_bits(self.kbits[:n].contiguous(), self.kdt)
        vals = None if self.vbits is None else from_bits(
            self.vbits[:n].contiguous(), self.vdt)
        return keys, vals


def _swap(bits, partner, want_swap):
    ws = want_swap.reshape(want_swap.shape + (1,) * (bits.dim() - 1))
    return torch.where(ws, bits[partner], bits)


def _bitonic(keys, vals):
    keys, vals, n_orig = _pad_pow2(keys, vals)
    n = keys.shape[0]
    net = _Net(keys, vals)
    if n > 1:
        idx = torch.arange(n, device=keys.device)
        for stage in range(1, int(math.log2(n)) + 1):
            direction = (idx & (1 << stage)) == 0   # ascending where unset
            for sub in reversed(range(stage)):
                net.stage(1 << sub, direction)
    return net.result(n_orig)


def bitonic_sort(keys: torch.Tensor) -> torch.Tensor:
    """Sort ascending along axis 0: ``(n,)`` keys, or ``(n, L)`` unsigned
    lex keys. Any n (padded with the sentinel to a power of two)."""
    out, _ = _bitonic(keys, None)
    return out


def bitonic_sort_kv(keys: torch.Tensor, vals: torch.Tensor):
    """:func:`bitonic_sort` with ``vals`` moved alongside (not compared)."""
    return _bitonic(keys, vals)


def _merge_network(keys, vals):
    """Merge phases only (the input must be bitonic, e.g. asc ++ desc)."""
    n = keys.shape[0]
    net = _Net(keys, vals)
    direction = torch.ones(n, dtype=torch.bool, device=keys.device)
    sub = n >> 1
    while sub >= 1:
        net.stage(sub, direction)
        sub >>= 1
    return net.result(n)


def _check_pow2(n: int):
    if n & (n - 1):
        raise ValueError("block length must be a power of two")


def bitonic_merge(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Merge two ascending blocks of equal power-of-two length in O(log n)
    phases."""
    if a.shape != b.shape:
        raise ValueError("blocks must have equal shapes")
    _check_pow2(a.shape[0])
    out, _ = _merge_network(_asc_desc(a, b), None)
    return out


def bitonic_merge_kv(ak, av, bk, bv):
    """Key-value :func:`bitonic_merge`: ``(keys, vals)``; values move with
    their keys and do not take part in the compare."""
    _check_pow2(ak.shape[0])
    return _merge_network(_asc_desc(ak, bk),
                          _asc_desc(av, bv))


def bitonic_merge_lex(a_lanes, b_lanes):
    """Merge two tuple-sorted blocks of equal power-of-two length in
    O(log n) phases.

    ``a_lanes``/``b_lanes``: equal-length lists of same-shape 1-D tensors,
    each block ascending under the full-tuple lex compare (every lane takes
    part, lane 0 most significant). Returns the merged lane list (length
    ``2n``)."""
    a_lanes, b_lanes = list(a_lanes), list(b_lanes)
    n = a_lanes[0].shape[0]
    _check_pow2(n)
    lanes = [_asc_desc(a, b) for a, b in zip(a_lanes, b_lanes)]
    order = torch.stack([order_view(x) for x in lanes])
    bits = torch.stack([_bits(x) for x in lanes])
    idx = torch.arange(2 * n, device=order.device)
    sub = n
    while sub >= 1:
        partner = idx ^ sub
        pk = order[:, partner]
        is_lower = idx < partner
        want_swap = torch.where(is_lower, lex_gt_keys(order, pk),
                                lex_gt_keys(pk, order))
        order = torch.where(want_swap, pk, order)
        bits = torch.where(want_swap, bits[:, partner], bits)
        sub >>= 1
    return [from_bits(bits[a].contiguous(), x.dtype)
            for a, x in enumerate(lanes)]
