"""Packed rank keys: order-preserving compression of lex tuples into 1-2
uint32 lanes — the part of ``repro.kernels.keypack`` that ``pack_shortlex``
needs.

Every lane first embeds into uint32 by the canonical key transform
``lex.to_order_bits``; the embedded lanes then concatenate big-endian into a
64-bit budget rendered as a ``(hi, lo)`` uint32 pair, or one uint32 when
the total width fits 32 bits. ``max_values`` tightens an integer lane's
width (the shortlex length lane needs ``bit_length(4·lanes)`` bits). When
the tuple does not fit the budget, the packed pair is an order-preserving
*prefix* of it. torch cannot shift uint32, so the ``(hi, lo)`` shifts run
in int64 and are masked back to 32 bits.

The unpacking, the searchsorted ranks and the packed merge wait for the run
tier (ROADMAP A6).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from .lex import F32, dtype_code, to_order_bits

__all__ = ["PackPlan", "PackedKeys", "plan_pack", "pack_rank_keys",
           "pack_shortlex", "shortlex_max_values"]

_BUDGET_BITS = 64
_M32 = 0xFFFFFFFF


class PackPlan(NamedTuple):
    """Static description of how a lane tuple maps into the rank-key budget.

    ``bits``: biased width of every input lane; ``take``: how many of those
    bits land inside the 64-bit budget (0 once exhausted); ``exact``: the
    whole tuple fits, so packed order *is* the tuple order; ``covered``:
    leading lanes whose bits are fully inside the budget; ``n_packed``: 1
    when the total fits one uint32 lane, else 2."""

    bits: Tuple[int, ...]
    take: Tuple[int, ...]
    exact: bool
    covered: int
    n_packed: int


class PackedKeys(NamedTuple):
    """``pack_rank_keys`` result: 1-2 ``torch.uint32`` tensors + the plan."""

    lanes: Tuple
    plan: PackPlan


def _lane_bits(dtype, max_value: Optional[int]) -> int:
    code = dtype_code(dtype)
    if max_value is not None:
        if code == F32:
            raise TypeError("max_values only applies to integer lanes "
                            "(a bounded float lane would pack by truncation)")
        if max_value < 0:
            raise ValueError("max_values entries must be >= 0")
        return max(1, int(max_value).bit_length())
    return 32


def _norm_max_values(n_lanes: int, max_values):
    if max_values is None:
        return (None,) * n_lanes
    max_values = tuple(max_values)
    if len(max_values) != n_lanes:
        raise ValueError("max_values must have one entry per lane")
    return max_values


def plan_pack(dtypes, max_values=None) -> PackPlan:
    """Pure-static packing plan for lanes of ``dtypes`` (torch dtypes).

    ``max_values``: optional per-lane upper bounds. A bounded lane promises
    its values lie in ``[0, max_value]`` and packs in
    ``bit_length(max_value)`` bits instead of the full dtype width."""
    dtypes = tuple(dtypes)
    max_values = _norm_max_values(len(dtypes), max_values)
    bits = tuple(_lane_bits(d, m) for d, m in zip(dtypes, max_values))
    budget = _BUDGET_BITS
    take, covered, partial_seen = [], 0, False
    for b in bits:
        w = min(b, budget)
        take.append(w)
        budget -= w
        if w == b and not partial_seen:
            covered += 1
        else:
            partial_seen = True
    total = sum(bits)
    return PackPlan(bits=bits, take=tuple(take), exact=total <= _BUDGET_BITS,
                    covered=covered, n_packed=1 if total <= 32 else 2)


def _as_u64(x: torch.Tensor, max_value: Optional[int]) -> torch.Tensor:
    """A lane's order bits as int64 values in [0, 2^32)."""
    bits = to_order_bits(x, max_value).view(torch.int32)
    return bits.to(torch.int64) & _M32


def _to_u32(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> a ``torch.uint32`` tensor."""
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(
        torch.int32).view(torch.uint32)


def _shl64_or(hi, lo, w: int, v):
    """(hi, lo) <<= w, then OR ``v`` (< 2^w) into the low bits, on int64
    halves in [0, 2^32). ``w`` is a static int in [1, 32]; the caller's
    budget bookkeeping guarantees no real bits shift off the top."""
    if w == 32:
        return lo, v
    return (((hi << w) | (lo >> (32 - w))) & _M32,
            ((lo << w) | v) & _M32)


def pack_rank_keys(lanes, max_values=None) -> PackedKeys:
    """Pack parallel 32-bit lanes (lane 0 most significant) into 1-2
    ``torch.uint32`` rank-key tensors whose unsigned lex order equals — or,
    past the budget, prefix-filters — the lanes' ``lex_gt_lanes`` order.
    ``repro.kernels.keypack.pack_rank_keys`` bit for bit."""
    lanes = list(lanes)
    if not lanes:
        raise ValueError("need at least one lane")
    max_values = _norm_max_values(len(lanes), max_values)
    plan = plan_pack([a.dtype for a in lanes], max_values)
    if plan.n_packed == 1:
        acc = None
        for a, mv, w in zip(lanes, max_values, plan.take):
            v = _as_u64(a, mv)
            acc = v if acc is None else ((acc << w) | v) & _M32
        return PackedKeys((_to_u32(acc),), plan)
    shape = torch.broadcast_shapes(*[a.shape for a in lanes])
    hi = torch.zeros(shape, dtype=torch.int64, device=lanes[0].device)
    lo = torch.zeros_like(hi)
    for a, mv, b, w in zip(lanes, max_values, plan.bits, plan.take):
        if w == 0:
            break
        v = _as_u64(a, mv)
        if w < b:
            v = v >> (b - w)  # prefix filter: keep the top bits only
        hi, lo = _shl64_or(hi, lo, w, v)
    return PackedKeys((_to_u32(hi), _to_u32(lo)), plan)


def shortlex_max_values(n_key_lanes: int):
    """``max_values`` for the shortlex tuple ``(length, lane0, ...,
    laneL-1)``: byte length is bounded by ``4 * L``, key lanes are full
    uint32."""
    return (4 * n_key_lanes,) + (None,) * n_key_lanes


def pack_shortlex(lengths: torch.Tensor, keys: torch.Tensor) -> PackedKeys:
    """Pack the shortlex tuple of a sorted run — ``lengths`` (n,) int32 byte
    lengths, ``keys`` (n, L) ``torch.uint32`` packed words — into rank keys
    with the tight length-lane width."""
    lanes = [lengths] + [keys[:, l] for l in range(keys.shape[1])]
    return pack_rank_keys(lanes, shortlex_max_values(keys.shape[1]))
