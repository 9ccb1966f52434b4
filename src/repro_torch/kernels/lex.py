"""The canonical total-order key plane of the port, in PyTorch.

The counterpart of ``repro.kernels.lex``: one definition of "less than"
for every comparator tier. :func:`to_order_bits` maps each 32-bit lane into
uint32 *order bits* whose unsigned order is the lane's total order —
unsigned ints pass through, signed ints flip the sign bit, and float32
takes the IEEE total-order flip with ``-0.0`` normalised to ``+0.0`` and
**every NaN strictly above ``+inf``**, the all-ones pattern (the float
padding sentinel) strictly above the other NaNs. Engines compare order bits
and swap the raw bits, so an output is always a bit-level permutation of
its input.

torch has no ``>``, ``>>``, ``+`` or ``max`` for ``torch.uint32``, so the
port carries every 32-bit lane as a bit-identical ``int32`` view and names
its logical type with a small integer *code* (:data:`U32`, :data:`I32`,
:data:`F32`) — the same codes the CUDA kernels read. Comparisons run on
:func:`order_keys`: the order bits with the top bit flipped, whose *signed*
int32 order is the unsigned order of the order bits. ``torch.uint32``
tensors appear only at the public functions.

A sort works on a *stacked* lane tensor ``x`` of shape ``(A, ...)`` int32:
entry ``a`` is lane ``a`` of every element, lane 0 most significant, and
trailing lanes are payloads that double as final tie-breaks (the
conventions of ``repro.kernels.lex``).

Narrow integer lanes (int8, int16, uint8, uint16) are taken as the
reference takes them. The kernels read 32-bit lanes only, so
:func:`as_bits` widens a narrow lane into int32 under the ``I32`` code
(sign-extending the signed types, zero-extending the unsigned ones), which
keeps its order and loses nothing, and :func:`from_bits` narrows it back
exactly. Their order bits are the reference's: a signed narrow lane shifts
by ``2^(bits-1)`` into ``[0, 2^bits)``, an unsigned one passes through.
float16 and bfloat16 raise ``TypeError``, as in the reference.

:func:`lex_rank_count` and :func:`lex_merge_take` are the broadcast merge
oracles of the run tier: O(|a|·|b|) compares, kept for the tests and the
``'lanes'`` merge engine; the production merges rank through
``keypack.lex_searchsorted``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

__all__ = ["U32", "I32", "F32", "MAX_ARRAYS", "dtype_code", "as_bits",
           "from_bits", "sentinel_bits", "pad_bits", "sentinel_for",
           "codes_mask", "to_order_bits", "from_order_bits", "order_view",
           "order_keys", "lex_gt_keys", "lex_gt_lanes", "lex_rank_count",
           "lex_merge_take", "scatter_merge", "map_lanes", "select_lanes"]

# lane type codes, as the CUDA kernels read them (csrc/common.cuh)
U32, I32, F32 = 0, 1, 2
# most arrays one sort takes: 8 key lanes and a payload lane
MAX_ARRAYS = 9

# narrow integer lanes, widened into int32 lanes under the I32 code
_NARROW = (torch.int8, torch.int16, torch.uint8, torch.uint16)
_CODES = {torch.uint32: U32, torch.int32: I32, torch.float32: F32,
          **dict.fromkeys(_NARROW, I32)}

_TOP = -(1 << 31)                 # 0x80000000 as an int32
_F32_NAN_ORDER = -2               # 0xFFFFFFFE: every NaN but the sentinel
_F32_SENTINEL_ORDER = -1          # 0xFFFFFFFF: the all-ones NaN
_F32_SENTINEL_BITS = -1
_F32_CANONICAL_NAN_BITS = 0x7FC00000
_F32_EXP = 0x7F800000
_F32_MAG = 0x7FFFFFFF


def dtype_code(dtype) -> int:
    """The lane code of a torch dtype: uint32, int32 and float32 lanes have
    their own; int8, int16, uint8 and uint16 lanes widen into ``I32``.
    Raises ``TypeError`` for any other dtype."""
    try:
        return _CODES[dtype]
    except KeyError:
        raise TypeError(f"cannot order-transform lanes of dtype {dtype}: the "
                        "port takes int8, int16, int32, uint8, uint16, uint32 "
                        "and float32 lanes") from None


def as_bits(x: torch.Tensor) -> torch.Tensor:
    """The int32 lane of ``x``: a 32-bit lane's bits (a view, no copy), a
    narrow integer lane widened — sign-extended if signed, zero-extended if
    not (a copy; uint16 goes through its int16 bit view, since torch
    computes little on ``torch.uint16``)."""
    dtype_code(x.dtype)
    if x.dtype == torch.int32:
        return x
    if x.dtype == torch.uint16:
        return x.view(torch.int16).to(torch.int32) & 0xFFFF
    if x.dtype in _NARROW:
        return x.to(torch.int32)
    return x.view(torch.int32)


def from_bits(bits: torch.Tensor, dtype) -> torch.Tensor:
    """Invert :func:`as_bits`: int32 bits viewed as a 32-bit ``dtype`` (no
    copy), or narrowed back into a narrow integer ``dtype`` (exact for
    values of its range)."""
    if dtype == torch.int32:
        return bits
    if dtype == torch.uint16:
        return bits.to(torch.int16).view(torch.uint16)
    if dtype in _NARROW:
        return bits.to(dtype)
    return bits.view(dtype)


def sentinel_bits(code: int) -> int:
    """The bits of a code's lex-maximal padding value, as an int32."""
    return (1 << 31) - 1 if code == I32 else -1


def pad_bits(dtype) -> int:
    """The int32 lane bits of ``dtype``'s own padding value
    (:func:`sentinel_for`): a narrow lane's ``iinfo.max`` widened, else
    :func:`sentinel_bits` of its code."""
    if dtype in _NARROW:
        return torch.iinfo(dtype).max
    return sentinel_bits(dtype_code(dtype))


def sentinel_for(dtype) -> torch.Tensor:
    """The lex-maximal padding value of ``dtype`` as a 0-d tensor:
    ``iinfo.max`` for ints (the positive max for signed) and, for float32,
    the all-ones-bits NaN, which the order places strictly above every other
    value including the other NaNs. Built from its bits, never from a float
    literal, so the NaN payload survives. Other floats get a NaN, as in the
    reference (no sort takes them)."""
    if dtype.is_floating_point and dtype != torch.float32:
        return torch.tensor(float("nan"), dtype=dtype)
    return from_bits(torch.tensor(pad_bits(dtype), dtype=torch.int32), dtype)


def codes_mask(codes: Sequence[int]) -> int:
    """Pack per-array codes, two bits each, lane 0 lowest — the ``codes``
    argument of every CUDA kernel of this package."""
    mask = 0
    for a, code in enumerate(codes):
        mask |= int(code) << (2 * a)
    return mask


def _f32_order_bits(b: torch.Tensor) -> torch.Tensor:
    """float32 bits (int32) -> order bits (int32 view of the uint32)."""
    mag = b & _F32_MAG
    bn = torch.where(mag == 0, torch.zeros_like(b), b)      # -0.0 -> +0.0
    flipped = torch.where(bn < 0, ~bn, bn | _TOP)
    nan_slot = torch.where(b == _F32_SENTINEL_BITS,
                           torch.full_like(b, _F32_SENTINEL_ORDER),
                           torch.full_like(b, _F32_NAN_ORDER))
    return torch.where(mag > _F32_EXP, nan_slot, flipped)


def _order_bits_of(bits: torch.Tensor, code: int) -> torch.Tensor:
    if code == U32:
        return bits
    if code == I32:
        return bits ^ _TOP
    return _f32_order_bits(bits)


def _narrow_half(dtype) -> int:
    """The shift of a signed narrow lane's order bits, ``2^(bits-1)``; 0
    for an unsigned one."""
    return -torch.iinfo(dtype).min


def to_order_bits(x: torch.Tensor,
                  max_value: Optional[int] = None) -> torch.Tensor:
    """Order-preserving uint32 embedding of one lane, returned as a
    ``torch.uint32`` tensor — ``repro.kernels.lex.to_order_bits`` bit for
    bit. ``max_value`` asserts a ``[0, max_value]`` range on an integer
    lane, whose values then pass through as they are. A narrow lane's bits
    lie in ``[0, 2^bits)``: signed ones shift by ``2^(bits-1)`` (not the
    32-bit sign flip), unsigned ones pass through."""
    code = dtype_code(x.dtype)
    bits = as_bits(x)
    if max_value is not None:
        if code == F32:
            raise TypeError("max_values only applies to integer lanes")
        return bits.view(torch.uint32)
    if x.dtype in _NARROW:
        return (bits + _narrow_half(x.dtype)).view(torch.uint32)
    return _order_bits_of(bits, code).view(torch.uint32)


def from_order_bits(v: torch.Tensor, dtype,
                    max_value: Optional[int] = None) -> torch.Tensor:
    """Invert :func:`to_order_bits` — exactly for integer lanes; for float32
    canonically: ``-0.0`` comes back as ``+0.0``, the sentinel slot as the
    all-ones NaN and the collapsed NaN slot as the canonical quiet NaN."""
    code = dtype_code(dtype)
    v = as_bits(v)
    if dtype in _NARROW:
        return from_bits(v if max_value is not None
                         else v - _narrow_half(dtype), dtype)
    if max_value is not None or code == U32:
        return from_bits(v, dtype)
    if code == I32:
        return v ^ _TOP
    b = torch.where(v < 0, v ^ _TOP, ~v)
    b = torch.where(v == _F32_NAN_ORDER,
                    torch.full_like(v, _F32_CANONICAL_NAN_BITS), b)
    b = torch.where(v == _F32_SENTINEL_ORDER,
                    torch.full_like(v, _F32_SENTINEL_BITS), b)
    return b.view(torch.float32)


def _order_key(bits: torch.Tensor, code: int) -> torch.Tensor:
    return bits if code == I32 else _order_bits_of(bits, code) ^ _TOP


def order_view(a: torch.Tensor) -> torch.Tensor:
    """The comparator's view of one lane: an int32 tensor whose *signed*
    order is the lane's total order (int32 lanes raw; uint32 lanes and the
    float32 order bits with the top bit flipped, since torch cannot compare
    uint32)."""
    return _order_key(as_bits(a), dtype_code(a.dtype))


def order_keys(x: torch.Tensor, codes: Sequence[int]) -> torch.Tensor:
    """:func:`order_view` of every entry of a stacked ``(A, ...)`` int32
    lane tensor whose entry ``a`` has code ``codes[a]``."""
    return torch.stack([_order_key(bits, code)
                        for bits, code in zip(x, codes)])


def lex_gt_keys(ka: torch.Tensor, kb: torch.Tensor) -> torch.Tensor:
    """Element-wise lexicographic ``a > b`` over stacked order keys
    ``(A, ...)``: entry 0 most significant, later entries break ties."""
    gt = ka[0] > kb[0]
    eq = ka[0] == kb[0]
    for a in range(1, ka.shape[0]):
        gt = gt | (eq & (ka[a] > kb[a]))
        eq = eq & (ka[a] == kb[a])
    return gt


def lex_gt_lanes(a_lanes, b_lanes) -> torch.Tensor:
    """Element-wise lexicographic ``a > b`` over parallel lane lists of
    32-bit tensors — ``repro.kernels.lex.lex_gt_lanes``: lane 0 most
    significant, each lane compared in its own total order."""
    ka = torch.stack([order_view(a) for a in a_lanes])
    kb = torch.stack([order_view(b) for b in b_lanes])
    return lex_gt_keys(ka, kb)


def lex_rank_count(a_lanes, b_lanes, strict: bool) -> torch.Tensor:
    """For each element of ``b``: how many elements of ``a`` are lex-below
    it (``strict``) or lex-at-or-below it (``not strict``), as int64 — the
    O(|a|·|b|) broadcast compare of ``repro.kernels.lex.lex_rank_count``."""
    a2 = [a[:, None] for a in a_lanes]
    b2 = [b[None, :] for b in b_lanes]
    cmp = lex_gt_lanes(b2, a2) if strict else ~lex_gt_lanes(a2, b2)
    return cmp.sum(dim=0)


def scatter_merge(a_lanes, b_lanes, rank_a: torch.Tensor,
                  rank_b: torch.Tensor) -> list:
    """Place ``a``'s elements at ``rank_a`` and ``b``'s at ``rank_b`` of
    ``|a| + |b|``-long lanes (the ranks must be a permutation); bits move
    unchanged."""
    out = []
    for a, b in zip(a_lanes, b_lanes):
        o = torch.empty(a.shape[0] + b.shape[0], dtype=torch.int32,
                        device=a.device)
        o[rank_a] = as_bits(a)
        o[rank_b] = as_bits(b)
        out.append(from_bits(o, a.dtype))
    return out


def lex_merge_take(a_lanes, b_lanes) -> list:
    """Merge two *sorted* lex-tuple runs (lists of parallel 1-D 32-bit
    tensors, any lengths) by merge-path rank + scatter —
    ``repro.kernels.lex.lex_merge_take``: each element goes to its own index
    plus the count of smaller elements of the other run, strict for ``a``
    and non-strict for ``b``, so equal tuples keep a before b. Key-only runs
    rank by ``torch.searchsorted`` over the order view; wider tuples pay the
    broadcast compare."""
    a_lanes, b_lanes = list(a_lanes), list(b_lanes)
    na, nb = a_lanes[0].shape[0], b_lanes[0].shape[0]
    dev = a_lanes[0].device
    if len(a_lanes) == 1:
        a0, b0 = order_view(a_lanes[0]), order_view(b_lanes[0])
        rank_a = torch.arange(na, device=dev) + torch.searchsorted(
            b0, a0, side="left")
        rank_b = torch.arange(nb, device=dev) + torch.searchsorted(
            a0, b0, side="right")
    else:
        rank_a = torch.arange(na, device=dev) + lex_rank_count(
            b_lanes, a_lanes, strict=True)
        rank_b = torch.arange(nb, device=dev) + lex_rank_count(
            a_lanes, b_lanes, strict=False)
    return scatter_merge(a_lanes, b_lanes, rank_a, rank_b)


def map_lanes(fn, arrs) -> list:
    """Apply ``fn`` (a partner shuffle: roll, flip, ...) to every lane."""
    return [fn(a) for a in arrs]


def select_lanes(mask: torch.Tensor, on_true, on_false) -> list:
    """``torch.where`` across parallel lane lists (the swap step)."""
    return [torch.where(mask, t, f) for t, f in zip(on_true, on_false)]
