"""Packed rank keys: order-preserving compression of lex tuples into 1-2
uint32 lanes — the part of ``repro.kernels.keypack`` that ``pack_shortlex``
needs.

Every lane first embeds into uint32 by the canonical key transform
``lex.to_order_bits``; the embedded lanes then concatenate big-endian into a
64-bit budget rendered as a ``(hi, lo)`` uint32 pair, or one uint32 when
the total width fits 32 bits. A narrow integer lane takes its own width (8
or 16 bits); ``max_values`` tightens an integer lane's width (the shortlex
length lane needs ``bit_length(4·lanes)`` bits). When
the tuple does not fit the budget, the packed pair is an order-preserving
*prefix* of it. torch cannot shift uint32, so the ``(hi, lo)`` shifts run
in int64 and are masked back to 32 bits.

The run tier's half: :func:`unpack_rank_keys`; the minimal compare-lane
list of a tuple (:func:`packed_cmp_lanes`, :func:`cmp_from_packed`); the
binary-search merge-path rank :func:`lex_searchsorted` (a loop of gathers
over stacked order keys); and the searchsorted-fast two-run merge
:func:`merge_take_packed`. Ranks are int64, torch's index type.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from .lex import (F32, dtype_code, from_order_bits, lex_gt_keys, order_view,
                  scatter_merge, to_order_bits)

__all__ = ["PackPlan", "PackedKeys", "plan_pack", "bias_to_u32",
           "pack_rank_keys", "pack_shortlex", "shortlex_max_values",
           "unpack_rank_keys", "packed_cmp_lanes", "cmp_from_packed",
           "lex_searchsorted", "packed_searchsorted", "merge_take_packed"]

_BUDGET_BITS = 64
_M32 = 0xFFFFFFFF

# the packing literature's name for the per-lane key transform; one
# definition of order bits, in lex
bias_to_u32 = to_order_bits


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
    return 32 if code == F32 else torch.iinfo(dtype).bits


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


def unpack_rank_keys(packed_lanes, dtypes, max_values=None) -> list:
    """Invert :func:`pack_rank_keys` (exact plans only): the original lanes
    of ``dtypes`` (torch dtypes), bit-identical for integer lanes; float32
    comes back canonical (``-0.0`` as ``+0.0``, see ``lex.from_order_bits``)."""
    dtypes = tuple(dtypes)
    max_values = _norm_max_values(len(dtypes), max_values)
    plan = plan_pack(dtypes, max_values)
    if not plan.exact:
        raise ValueError("cannot unpack a lossy (inexact) rank-key packing")
    packed_lanes = list(packed_lanes)
    if len(packed_lanes) != plan.n_packed:
        raise ValueError(f"expected {plan.n_packed} packed lanes")
    fields = list(reversed(list(zip(dtypes, max_values, plan.take))))
    out = []
    if plan.n_packed == 1:
        acc = _as_u64(packed_lanes[0], None)
        for dt, mv, w in fields:
            out.append(from_order_bits(_to_u32(acc & ((1 << w) - 1)), dt, mv))
            acc = acc >> w
        return list(reversed(out))
    hi, lo = (_as_u64(p, None) for p in packed_lanes)
    for dt, mv, w in fields:
        if w == 32:
            val, hi, lo = lo, torch.zeros_like(hi), hi
        else:
            val = lo & ((1 << w) - 1)
            lo = ((lo >> w) | (hi << (32 - w))) & _M32
            hi = hi >> w
        out.append(from_order_bits(_to_u32(val), dt, mv))
    return list(reversed(out))


def cmp_from_packed(packed_lanes, lanes, max_values=None) -> list:
    """The minimal compare-lane list of ``lanes`` from rank keys packed
    earlier: the packed lanes alone when the plan is exact, else the packed
    prefix plus the lane-wise tie-break suffix from the first lane the
    budget does not cover — or the raw lanes when that is no shorter."""
    lanes = list(lanes)
    plan = plan_pack([a.dtype for a in lanes], max_values)
    packed_lanes = list(packed_lanes)
    if plan.exact:
        return packed_lanes
    cand = packed_lanes + lanes[plan.covered:]
    return cand if len(cand) <= len(lanes) else lanes


def packed_cmp_lanes(lanes, max_values=None) -> list:
    """:func:`cmp_from_packed` of a fresh packing; lanes that cannot pack
    (a dtype the port does not take) come back as they are. Lex order over
    the result equals ``lex_gt_lanes`` order over ``lanes``."""
    lanes = list(lanes)
    try:
        pk = pack_rank_keys(lanes, max_values)
    except TypeError:
        return lanes
    return cmp_from_packed(pk.lanes, lanes, max_values)


def lex_searchsorted(a_lanes, v_lanes, side: str = "left") -> torch.Tensor:
    """For every lex tuple of ``v_lanes``, its insertion point into the
    lex-sorted tuples of ``a_lanes`` (int64) — a vectorised binary search of
    ``bit_length(|a|) + 1`` rounds, one gather and one lex compare of the
    stacked order keys each (``repro.kernels.keypack.lex_searchsorted``).
    Single-lane inputs take ``torch.searchsorted`` on the order view."""
    if side not in ("left", "right"):
        raise ValueError(f"unknown side {side!r}")
    a_lanes, v_lanes = list(a_lanes), list(v_lanes)
    if len(a_lanes) != len(v_lanes):
        raise ValueError("a_lanes and v_lanes must have the same arity")
    if len(a_lanes) == 1:
        return torch.searchsorted(order_view(a_lanes[0]),
                                  order_view(v_lanes[0]), side=side)
    n = a_lanes[0].shape[0]
    shape = v_lanes[0].shape
    dev = v_lanes[0].device
    lo = torch.zeros(shape, dtype=torch.int64, device=dev)
    if n == 0:
        return lo
    ka = torch.stack([order_view(a) for a in a_lanes])
    kv = torch.stack([order_view(v) for v in v_lanes])
    hi = torch.full(shape, n, dtype=torch.int64, device=dev)
    for _ in range(int(n).bit_length() + 1):
        mid = (lo + hi) >> 1
        a_mid = ka[:, mid.clamp(max=n - 1)]
        if side == "left":
            pred = lex_gt_keys(kv, a_mid)           # a[mid] <  v
        else:
            pred = ~lex_gt_keys(a_mid, kv)          # a[mid] <= v
        pred &= mid < hi                            # frozen once converged
        lo = torch.where(pred, mid + 1, lo)
        hi = torch.where(pred, hi, mid)
    return lo


def packed_searchsorted(a_lanes, v_lanes, side: str = "left",
                        max_values=None) -> torch.Tensor:
    """:func:`lex_searchsorted` over the packed compare lists of both tuple
    sets (``a_lanes`` lex-sorted)."""
    return lex_searchsorted(packed_cmp_lanes(a_lanes, max_values),
                            packed_cmp_lanes(v_lanes, max_values), side=side)


def merge_take_packed(a_lanes, b_lanes, n_cmp: Optional[int] = None,
                      max_values=None) -> list:
    """Merge two *sorted* lex-tuple runs by packed merge-path ranks and one
    scatter per lane — ``repro.kernels.keypack.merge_take_packed``: equal
    tuples keep a before b and in-run order, every output slot is written
    once. ``n_cmp``: the leading ``n_cmp`` lanes are the compare list as
    they are (pre-packed by the caller); ``None`` packs it from all lanes."""
    a_lanes, b_lanes = list(a_lanes), list(b_lanes)
    if len(a_lanes) != len(b_lanes):
        raise ValueError("runs must have the same lane arity")
    na, nb = a_lanes[0].shape[0], b_lanes[0].shape[0]
    if n_cmp is None:
        cmp_a = packed_cmp_lanes(a_lanes, max_values)
        cmp_b = packed_cmp_lanes(b_lanes, max_values)
    else:
        cmp_a, cmp_b = a_lanes[:n_cmp], b_lanes[:n_cmp]
    dev = a_lanes[0].device
    rank_a = torch.arange(na, device=dev) + lex_searchsorted(cmp_b, cmp_a,
                                                             side="left")
    rank_b = torch.arange(nb, device=dev) + lex_searchsorted(cmp_a, cmp_b,
                                                             side="right")
    return scatter_merge(a_lanes, b_lanes, rank_a, rank_b)
