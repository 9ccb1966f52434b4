"""Mesh-scale distributed sort engines — the counterpart of
``repro.core.distributed``: the paper's distribute step across devices.

OpenMP's ``parallel for`` over buckets has no analogue across devices that
share no memory, but the paper's decomposition generalizes two ways, both
behind one front-end (``distributed_sort`` / ``distributed_sort_lex``):

  * ``'odd_even'`` — each rank's shard is one "element"; ring neighbours
    compare-exchange (merge their sorted blocks and keep the low or high
    half) over :func:`~repro_torch.parallel.compat.ppermute`. P alternating
    odd/even rounds sort P blocks: odd-even transposition at block
    granularity, *bubble sort across the mesh*. O(P) rounds, O(P·B) bytes a
    rank.
  * ``'sample'`` — splitter one-shot (sample sort, arXiv:1411.5283): global
    splitters from one ``all_gather`` of samples, every block partitioned by
    splitter bucket — the paper's distribute-into-sub-arrays step keyed by
    value range — exchanged with ONE ``all_to_all``, combined locally.

``choose_engine(P, B)`` is the cost model: odd_even at P <= 2, sample
beyond.

Both engines are variadic over lexicographic tuples (``kernels/lex.py``:
lane 0 most significant, trailing lanes payload and tie-break, every lane
through one permutation). Device-local sorts go through the port's kernel
path, ``kernels.ops.sort_lex`` (its plain version on a CPU tensor), and the
two-run merges through ``kernels.ops.merge_sorted_lex`` (the merge-path
kernel, B5, on a CUDA tensor past two blocks).

**SPMD, as the reference's ``shard_map`` bodies.** The engine functions are
called by every rank of the axis's ``ProcessGroup`` with its own ``(B,)``
shard and return that rank's shard; they talk only through the five steps
of ``parallel.compat``. The host-facing ``distributed_sort_lex`` is called
collectively with the same global lanes on every rank, and every rank
returns the same sorted tuple. On one card the ranks are processes on
``cuda:0`` whose collectives go through gloo, staged through the host
(``parallel.compat``); NCCL takes one rank a card.

Exact-count exchange protocol (no silent data loss): beside the data
``all_to_all`` the sample engine ``all_gather``s the true per-destination
count vectors (a (P, P) matrix on every rank), so receivers know exactly
how many real elements arrived from each source — validity never comes
from comparing values with the sentinel (real ``iinfo.max`` ints and
sentinel-bit floats count right), capacity overflow is an explicit flag,
and the host-facing wrappers size capacity at the worst case B by default.
Non-divisible inputs are sentinel-padded to a multiple of P and sliced
back.

Merge strategies of the odd_even engine, all full-tuple lex:
  * 'resort'  — re-sort the 2B concatenation (the paper-faithful baseline)
  * 'bitonic' — O(log B) bitonic merge of the two sorted blocks
                (``core.bitonic.bitonic_merge_lex``, the reference's network)
  * 'take'    — merge-path ranks and one scatter
                (``kernels.ops.merge_sorted_lex``)

Each odd_even round sends the whole block both ways and both partners
compute the merge, as the reference does.

``distributed_chunked_sort_lex`` is the out-of-core mesh sort of packed
shortlex words: one process placing chunks on explicit devices (repeats
allowed: eight destinations on one card), an exact-count exchange of whole
sorted sub-runs, and one k-way combine per destination, with the run store,
the shard spill and resume, and the supervisor's retries and speculation.
"""

from __future__ import annotations

import logging
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..interop import resolve_device, to_device
from ..kernels.keypack import lex_searchsorted, packed_searchsorted
from ..kernels.lex import as_bits, from_bits, order_view, pad_bits
from ..kernels.ops import merge_sorted_lex, sort_lex
from ..parallel.compat import (all_gather, all_to_all, axis_index, axis_size,
                               ppermute)
from .bitonic import bitonic_merge, bitonic_merge_lex

__all__ = [
    "choose_engine", "local_merge",
    "odd_even_block_sort", "odd_even_block_sort_lex",
    "sample_sort", "sample_sort_lex", "sample_sort_exact", "SampleSortResult",
    "distributed_sort", "distributed_sort_kv", "distributed_sort_lex",
    "distributed_chunked_sort_lex",
]

log = logging.getLogger("repro_torch.core")


# --------------------------------------------------------------------------
# lanes as stacked bits
# --------------------------------------------------------------------------

def _bits(a: torch.Tensor) -> torch.Tensor:
    """A lane's int32 bits. Gathers, copies and concatenations of lanes
    run on these: torch implements few of them for ``torch.uint32``, none
    of its indexing on CUDA."""
    return as_bits(a).contiguous()


def _stack(lanes) -> torch.Tensor:
    """Parallel lanes as one ``(A, n)`` int32 tensor of their bits, so a
    collective moves every lane at once."""
    return torch.stack([_bits(a) for a in lanes])


def _unstack(bits: torch.Tensor, dtypes) -> list:
    return [from_bits(bits[a].contiguous(), dt) for a, dt in enumerate(dtypes)]


def _cat(parts) -> torch.Tensor:
    """Concatenate lanes of one dtype through their bits."""
    return from_bits(torch.cat([_bits(p) for p in parts]), parts[0].dtype)


def _fill(dtypes, n: int, device) -> torch.Tensor:
    """``(A, n)`` bits of every lane's lex-maximal padding value."""
    return torch.tensor([pad_bits(dt) for dt in dtypes], dtype=torch.int32,
                        device=device)[:, None].expand(-1, n).contiguous()


# --------------------------------------------------------------------------
# local sort / merge building blocks
# --------------------------------------------------------------------------

def _stable_lex_sort(lanes) -> list:
    """Full-tuple sort by stable ``torch.sort`` passes over the lanes' order
    keys from the last lane to the first; bits move through the one
    permutation."""
    lanes = list(lanes)
    perm = torch.arange(lanes[0].shape[0], device=lanes[0].device)
    for a in reversed(lanes):
        _, idx = torch.sort(order_view(a)[perm], stable=True)
        perm = perm[idx]
    return [from_bits(as_bits(a)[perm], a.dtype) for a in lanes]


def _local_sort_fn(local_sort):
    """Resolve the device-local tuple sort: 'pallas' and 'auto' are the
    port's kernel path ``kernels.ops.sort_lex`` (its kernels on a CUDA
    tensor, their plain versions on a CPU one — the reference's 'auto' is
    the Pallas path on TPU and XLA's sort elsewhere); 'xla' is a stable
    multi-pass ``torch.sort`` of the order keys, standing in for XLA's
    variadic sort; or a callable ``lanes -> lanes``."""
    if callable(local_sort):
        return local_sort
    if local_sort in ("auto", "pallas"):
        return lambda lanes: list(sort_lex(list(lanes)))
    if local_sort == "xla":
        return _stable_lex_sort
    raise ValueError(f"unknown local_sort {local_sort!r}")


def _merge_resort_lex(mine, theirs, sort_fn):
    return sort_fn([_cat([m, t]) for m, t in zip(mine, theirs)])


def _merge_bitonic_lex(mine, theirs, sort_fn):
    return bitonic_merge_lex(mine, theirs)


def _merge_take_lex(mine, theirs, sort_fn):
    # merge-path ranks and one scatter — the run tier's two-run merge
    return list(merge_sorted_lex(tuple(mine), tuple(theirs)))


_MERGES_LEX = {"resort": _merge_resort_lex, "bitonic": _merge_bitonic_lex,
               "take": _merge_take_lex}


def _merge_sorted_rows_lex(rows):
    """Merge the rows of parallel ``(r, L)`` lane tensors — each row-tuple
    lex ascending, r a power of two — into one sorted lane tuple of
    ``(r*L,)`` tensors by a merge-path tree: log2(r) rounds pairing rows
    ``(0, 1), (2, 3), ...`` as the reference's vmapped rounds do."""
    rows = list(rows)
    runs = [tuple(x[i] for x in rows) for i in range(rows[0].shape[0])]
    while len(runs) > 1:
        runs = [merge_sorted_lex(runs[i], runs[i + 1])
                for i in range(0, len(runs), 2)]
    return list(runs[0])


def local_merge(mine, theirs, strategy: str = "bitonic"):
    """Merge two sorted key-only blocks (the 1-tuple view of the lex
    merge)."""
    if strategy == "bitonic":
        return bitonic_merge(mine, theirs)
    (out,) = _MERGES_LEX[strategy]([mine], [theirs], _stable_lex_sort)
    return out


# --------------------------------------------------------------------------
# engine 1: odd-even block sort (bubble sort across the mesh)
# --------------------------------------------------------------------------

def odd_even_block_sort_lex(lanes, group=None, merge: str = "bitonic",
                            local_sort="auto"):
    """Sort lex tuples distributed over the ranks of ``group``.

    SPMD: every rank calls it with its own same-shape ``(B,)`` lanes — key
    lanes first, payload and tie-break lanes last — and gets back its shard
    of the globally ascending tuple. ``merge``: 'resort' | 'bitonic' (pow2
    B) | 'take'; ``local_sort``: see :func:`distributed_sort_lex`.
    """
    if merge not in _MERGES_LEX:
        raise ValueError(f"unknown merge strategy {merge!r}")
    lanes = list(lanes)
    num, me = axis_size(group), axis_index(group)
    sort_fn = _local_sort_fn(local_sort)
    lanes = list(sort_fn(lanes))
    if num == 1:
        # no rank has a partner in any round (the reference's has_partner
        # is False throughout), so the local sort is the result
        return tuple(lanes)
    bsz = lanes[0].shape[0]
    dtypes = [a.dtype for a in lanes]
    for r in range(num):
        # round parity decides pairing: even r -> (0,1)(2,3)..; odd ->
        # (1,2)(3,4)..; exchange with both ring neighbours and select
        left_of_pair = (me % 2) == (r % 2)
        partner = me + 1 if left_of_pair else me - 1
        blk = _stack(lanes)
        from_left = ppermute(blk, group, 1)      # the block of rank me-1
        from_right = ppermute(blk, group, -1)    # the block of rank me+1
        if not 0 <= partner < num:
            continue
        theirs = _unstack(from_right if left_of_pair else from_left, dtypes)
        merged = _MERGES_LEX[merge](lanes, theirs, sort_fn)
        lanes = [m[:bsz] if left_of_pair else m[bsz:] for m in merged]
    return tuple(lanes)


def odd_even_block_sort(block, group=None, merge: str = "bitonic",
                        local_sort="auto"):
    """Key-only odd-even block sort (the 1-tuple view); ``block`` is this
    rank's ``(B,)`` shard. ``local_sort`` may also be an array -> array
    callable, as in the reference."""
    if callable(local_sort):
        one = local_sort
        fn = lambda ls: [one(ls[0])]  # noqa: E731 — adapt array fn to lanes
    else:
        fn = local_sort
    (out,) = odd_even_block_sort_lex([block], group, merge=merge,
                                     local_sort=fn)
    return out


# --------------------------------------------------------------------------
# engine 2: sample sort (splitter one-shot with exact-count exchange)
# --------------------------------------------------------------------------

class SampleSortResult(NamedTuple):
    """Per-rank result of :func:`sample_sort_lex`.

    ``lanes``: tuple of ``(P*capacity,)`` sorted tensors — real elements
    occupy the prefix ``[0, count)``; slots beyond hold sentinel fill.
    ``count`` is exact (from the exchanged counts, never from values).
    ``overflow`` is True iff some source had more than ``capacity``
    elements destined for *this* rank and the excess was clipped (OR the
    flags across the axis for a global verdict)."""

    lanes: Tuple[torch.Tensor, ...]
    count: torch.Tensor
    overflow: torch.Tensor


def _sample_partition_exchange(lanes, group, n_valid, capacity,
                               oversample, local_sort):
    """Shared sample-sort core: local sort -> global splitters -> ONE
    all_to_all of data + one all_gather of the true count vectors. Returns
    ``(out_lanes, count_matrix, overflow, b, cap)``: ``out_lanes`` are this
    rank's ``(P*cap,)`` tensors with the real elements sorted in the prefix
    of length ``min(count_matrix[:, me], cap).sum()``; ``count_matrix[s,
    d]`` is the TRUE number of elements source s holds for destination d
    (before clipping, the same on every rank)."""
    lanes = list(lanes)
    num, me = axis_size(group), axis_index(group)
    b = lanes[0].shape[0]
    dev = lanes[0].device
    dtypes = [a.dtype for a in lanes]
    cap = capacity if capacity is not None else b
    sort_fn = _local_sort_fn(local_sort)

    # validity from construction, not from values: the host wrapper pads the
    # global tail, so rank me's real elements are a prefix of its shard
    local_valid = b if n_valid is None else min(max(n_valid - me * b, 0), b)

    # Invalid tail slots take the all-sentinel tuple BEFORE the sort: it is
    # lex-maximal, so fills sink to the tail and the first local_valid
    # slots hold exactly the real multiset; counts still come only from the
    # protocol, never from value comparisons.
    if local_valid < b:
        bits = _stack(lanes)
        bits[:, local_valid:] = _fill(dtypes, b - local_valid, dev)
        lanes = _unstack(bits, dtypes)
    local = list(sort_fn(lanes))
    local_bits = _stack(local)

    # evenly spaced local quantiles -> global splitters (invalid samples
    # take the lex-maximal sentinel tuple and sort past every real sample)
    stride = max(1, b // oversample)
    pos = torch.clamp(torch.arange(oversample, device=dev) * stride,
                      max=b - 1)
    samples = torch.where(pos < local_valid, local_bits[:, pos],
                          _fill(dtypes, oversample, dev))
    gathered = all_gather(samples, group)                # (P, A, oversample)
    gathered = gathered.permute(1, 0, 2).reshape(len(dtypes), -1)
    all_samples = _stack(_stable_lex_sort(_unstack(gathered, dtypes)))
    take = torch.tensor([(i + 1) * oversample for i in range(num - 1)],
                        dtype=torch.long, device=dev)
    splitters = _unstack(all_samples[:, take], dtypes)

    # bucket by splitter (the paper's distribute step): dest = #splitters
    # lex<= element, the packed rank-key binary search
    if num > 1:
        dest = packed_searchsorted(splitters, local, side="right")
    else:
        dest = torch.zeros(b, dtype=torch.long, device=dev)
    # rank within the destination bucket: the valid prefix is sorted, so
    # same-destination elements are contiguous; invalid slots go to the
    # discard bucket ``num`` and never enter the counts
    idx = torch.arange(b, device=dev)
    vmask = idx < local_valid
    dest_eff = torch.where(vmask, dest, num)
    counts = torch.bincount(dest_eff, minlength=num + 1)[:num]
    offsets = torch.cumsum(counts, 0) - counts
    rank = idx - offsets[torch.clamp(dest_eff, max=num - 1)]
    keep = vmask & (rank < cap)
    # dropped elements are simply not written (the reference writes them
    # all to one discard slot and slices it off)
    slot = (dest * cap + rank)[keep]
    buckets = _fill(dtypes, num * cap, dev)
    buckets[:, slot] = local_bits[:, keep]

    # ONE all_to_all for the data, ONE all_gather for the TRUE counts
    received = all_to_all(
        buckets.reshape(len(dtypes), num, cap).permute(1, 0, 2), group)
    count_matrix = all_gather(counts, group)             # [src, dst]
    overflow = torch.any(count_matrix[:, me] > cap)

    # Final combine: unfilled slots hold the all-sentinel tuple, so any
    # order-preserving combine leaves the real multiset in the count-sized
    # prefix. Each received row is a slice of a sorted block: a pow2 row
    # count takes a merge-path tree, otherwise the full-tuple sort.
    rows = _unstack(received.permute(1, 0, 2), dtypes)
    if num & (num - 1) == 0:
        out = _merge_sorted_rows_lex(rows)
    else:
        out = list(sort_fn([r.reshape(-1) for r in rows]))
    return out, count_matrix, overflow, b, cap


def sample_sort_lex(lanes, group=None, n_valid: Optional[int] = None,
                    capacity: Optional[int] = None, oversample: int = 8,
                    local_sort="auto") -> SampleSortResult:
    """Splitter-based distributed lex sort — the paper's bucketing at mesh
    scale, and the fix for the odd-even engine's O(P)-round wall.

    SPMD: every rank calls it with its own same-shape ``(B,)`` lanes.
    ``n_valid``: global count of real elements when the caller padded the
    tail of the *last* shards (as :func:`distributed_sort_lex` does); None =
    all real. ``capacity`` bounds the per-source-per-destination bucket;
    the default B is the worst case. Returns :class:`SampleSortResult` —
    the concatenation of every rank's valid prefix in rank order is the
    globally sorted sequence."""
    me = axis_index(group)
    out, count_matrix, overflow, _, cap = _sample_partition_exchange(
        lanes, group, n_valid, capacity, oversample, local_sort)
    count = torch.clamp(count_matrix[:, me], max=cap).sum()
    return SampleSortResult(tuple(out), count, overflow)


def sample_sort_exact(lanes, group=None, n_valid: Optional[int] = None,
                      capacity: Optional[int] = None, oversample: int = 8,
                      local_sort="auto"):
    """Sample sort returning *exactly placed* ``(B,)`` shards: a second
    ``all_to_all`` moves every element to the rank and slot of its global
    rank, so the shards in rank order are the globally sorted array with
    all padding at the tail.

    Global ranks come from the gathered count matrix, never from values;
    an occupancy row travels with the data, so receivers select real
    elements per slot without comparing against the sentinel. Returns
    ``(out_lanes, overflow, kept)``: ``overflow`` is this rank's inbound
    overflow flag; ``kept`` the *global* number of elements that survived
    capacity clipping (the same on every rank). Unfilled slots hold the
    lex-maximal sentinel tuple."""
    num, me = axis_size(group), axis_index(group)
    out, count_matrix, overflow, b, cap = _sample_partition_exchange(
        lanes, group, n_valid, capacity, oversample, local_sort)
    dtypes = [a.dtype for a in out]
    dev = out[0].device
    m = out[0].shape[0]

    # my elements' global ranks: the offset of my valid run + local index
    all_counts = torch.clamp(count_matrix, max=cap).sum(0)
    kept = all_counts.sum()
    my_off = (torch.cumsum(all_counts, 0) - all_counts)[me]
    i = torch.arange(m, device=dev)
    valid = i < all_counts[me]
    # bucket row = destination rank (pos // b), column = in-shard slot
    # (pos % b): the flat bucket index IS the global rank; an occupancy row
    # rides the same exchange
    slot = (my_off + i)[valid]
    buckets = torch.cat([_fill(dtypes, num * b, dev),
                         torch.zeros((1, num * b), dtype=torch.int32,
                                     device=dev)])
    buckets[:-1, slot] = _stack(out)[:, valid]
    buckets[-1, slot] = 1
    recv = all_to_all(
        buckets.reshape(len(dtypes) + 1, num, b).permute(1, 0, 2), group)
    # global positions are unique, so each slot has at most one occupied
    # source; empty slots keep source 0's sentinel fill (jnp.argmax's
    # first-of-ties)
    src = (recv[:, -1, :].long()
           * torch.arange(num, device=dev)[:, None]).sum(0)
    cols = torch.arange(b, device=dev)
    placed = recv[src, :-1, cols].T
    return tuple(_unstack(placed, dtypes)), overflow, kept


def sample_sort(block, group=None, capacity: int | None = None,
                oversample: int = 8, local_sort="auto"):
    """Key-only sample sort (the 1-tuple view). Returns ``(values,
    count)`` per rank: ``values`` is ``(P*capacity,)`` with the real
    elements sorted in the prefix ``[0, count)``; ``count`` is exact even
    when real elements equal the padding sentinel."""
    res = sample_sort_lex([block], group, capacity=capacity,
                          oversample=oversample, local_sort=local_sort)
    return res.lanes[0], res.count


# --------------------------------------------------------------------------
# engine selection + host-facing front-end
# --------------------------------------------------------------------------

def choose_engine(num_devices: int, block: int, engine: str = "auto") -> str:
    """Pick the mesh engine for P ranks of B-element blocks: odd_even moves
    O(P·B) bytes a rank over P latency-bound rounds, sample O(B) in one
    all_to_all plus an O(P·oversample) splitter all_gather; the splitter
    machinery only loses at P <= 2. Explicit ``engine`` overrides."""
    if engine != "auto":
        if engine not in ("odd_even", "sample"):
            raise ValueError(f"unknown engine {engine!r}")
        return engine
    return "odd_even" if num_devices <= 2 else "sample"


def _pad_tail(a: torch.Tensor, npad: int) -> torch.Tensor:
    if a.shape[0] == npad:
        return a
    fill = _fill([a.dtype], npad - a.shape[0], a.device)[0]
    return _cat([a, from_bits(fill, a.dtype)])


def _gather_blocks(lanes, group, n: int) -> tuple:
    """Every rank's block of ``lanes``, in rank order, cut to ``n``: one
    ``all_gather`` of the stacked lanes."""
    g = all_gather(_stack(lanes), group)                 # (P, A, b)
    flat = g.permute(1, 0, 2).reshape(len(lanes), -1)[:, :n]
    return tuple(_unstack(flat, [a.dtype for a in lanes]))


def distributed_sort_lex(keys_lanes, mesh, axis: str = "data", vals=None,
                         engine: str = "auto", merge: str = "bitonic",
                         local_sort="auto", oversample: int = 8,
                         capacity: int | None = None,
                         on_overflow: str = "raise", validate: str = "off",
                         device="cuda"):
    """Sort 1-D lex tuples over the ranks of ``axis`` of ``mesh`` (a
    ``DeviceMesh``, ``parallel.compat.make_mesh``). Called collectively:
    every rank passes the same global lanes (numpy arrays or tensors), pads
    them to ``b * P``, sorts block ``rank`` with the engine, and gathers
    every block, so every rank returns the same sorted tuple on ``device``.

    ``keys_lanes``: same-shape 1-D lanes, lane 0 most significant; optional
    ``vals`` rides the keys' permutation as the final tie-break lane.
    ``engine``: 'auto' (:func:`choose_engine`), 'odd_even' or 'sample';
    ``merge`` applies to odd_even only ('bitonic' needs pow2 blocks, else
    'resort' runs). ``local_sort``: 'auto' | 'pallas' (the kernel path) |
    'xla' (stable ``torch.sort`` passes) | a callable.

    ``capacity`` (sample engine only) bounds the per-source-per-destination
    exchange bucket; the default ``None`` sizes it at the block, so nothing
    can drop. On overflow — flagged by any rank, the flags gathered from
    every rank so that every rank acts alike — ``on_overflow``:
      * ``'raise'`` — raise ``runtime.CapacityOverflow``;
      * ``'retry'`` — double the capacity and run again until the exchange
        fits (the block size always fits), logging each escalation;
      * ``'clip'``  — return only the surviving elements, with a warning.

    ``validate``: ``'off'`` | ``'cheap'`` (the output is lex-sorted and, on
    lossless paths, keeps the element count) | ``'full'`` (adds multiset
    conservation by ``pipeline.validate``'s content digest); raises
    ``pipeline.validate.ValidationError``.

    Returns a tuple of sorted lanes, or ``(lanes, sorted_vals)``.
    """
    from ..runtime.failure import CapacityOverflow
    if on_overflow not in ("raise", "retry", "clip"):
        raise ValueError(f"unknown on_overflow policy {on_overflow!r}")
    dev = resolve_device(device)
    arrs = list(keys_lanes) + ([vals] if vals is not None else [])
    arrs = [to_device(a, dev) for a in arrs]
    if not arrs or any(a.dim() != 1 for a in arrs):
        raise ValueError("need 1-D lanes")
    if any(a.shape != arrs[0].shape for a in arrs[1:]):
        raise ValueError("all lanes (and vals) must have identical shapes")
    group = mesh.get_group(axis)
    n = arrs[0].shape[0]
    num, me = axis_size(group), axis_index(group)
    b = -(-n // num) if n else 1
    eng = choose_engine(num, b, engine)
    if eng == "odd_even" and merge == "bitonic" and b & (b - 1):
        merge = "resort"  # bitonic merge needs pow2 blocks; stay exact
    cap = capacity if eng == "sample" else None
    block = [_pad_tail(a, b * num)[me * b:(me + 1) * b] for a in arrs]
    clipped = False
    while True:
        if eng == "odd_even":
            mine = odd_even_block_sort_lex(block, group, merge=merge,
                                           local_sort=local_sort)
            out = _gather_blocks(mine, group, n)
            break
        mine, ovf, kept = sample_sort_exact(
            block, group, n_valid=n, capacity=cap, oversample=oversample,
            local_sort=local_sort)
        if cap is None or not bool(all_gather(ovf, group).any()):
            out = _gather_blocks(mine, group, n)
            break
        if on_overflow == "raise":
            # the exchange reports the flag, not the exact need: required
            # is the always-sufficient block size
            raise CapacityOverflow(
                f"sample-sort exchange overflowed capacity {cap} "
                f"(block size {b} always fits)", cap, required=b)
        if on_overflow == "clip":
            kept_n = int(kept)
            log.warning("sample-sort exchange overflow: clipping %d "
                        "element(s) past capacity %d", n - kept_n, cap)
            out = _gather_blocks(mine, group, kept_n)
            clipped = True
            break
        new_cap = min(cap * 2, b)
        log.warning("sample-sort exchange overflow: capacity %d -> %d "
                    "(retry)", cap, new_cap)
        cap = new_cap
    if validate != "off":
        from ..pipeline.validate import (ValidationError, check_lanes_sorted,
                                         check_multiset)
        check_lanes_sorted(out, what="distributed_sort_lex output")
        if not clipped:
            if out[0].shape[0] != n:
                raise ValidationError(
                    f"distributed_sort_lex lost elements: {out[0].shape[0]}"
                    f" != {n}")
            if validate == "full":
                check_multiset(arrs, out,
                               what="distributed_sort_lex multiset")
    if vals is None:
        return out
    return out[:-1], out[-1]


def distributed_sort(x, mesh, axis: str = "data", engine: str = "auto",
                     merge: str = "bitonic", local_sort="auto",
                     device="cuda"):
    """Sort a 1-D array over ``axis`` of ``mesh`` (the key-only view of
    :func:`distributed_sort_lex`); any length, any engine."""
    (out,) = distributed_sort_lex((x,), mesh, axis=axis, engine=engine,
                                  merge=merge, local_sort=local_sort,
                                  device=device)
    return out


def distributed_sort_kv(keys, vals, mesh, axis: str = "data",
                        engine: str = "auto", merge: str = "bitonic",
                        local_sort="auto", device="cuda"):
    """Key-value view of :func:`distributed_sort_lex`: ``vals`` rides the
    keys' permutation as the final tie-break lane."""
    if keys.shape != vals.shape:
        raise ValueError("keys and vals must have identical shapes")
    lanes, ov = distributed_sort_lex((keys,), mesh, axis=axis, vals=vals,
                                     engine=engine, merge=merge,
                                     local_sort=local_sort, device=device)
    return lanes[0], ov


# --------------------------------------------------------------------------
# out-of-core: chunk-per-device ingest + run exchange + streaming combine
# --------------------------------------------------------------------------

_NP_DTYPES = {torch.uint32: np.uint32, torch.int32: np.int32,
              torch.float32: np.float32}


def _chunk_devices(mesh, axis, devices) -> list:
    """The destinations: ``devices`` as given (repeats allowed), else one a
    rank of ``mesh`` in its flat order (a rank's card is ``rank %`` the
    local card count), else every local card."""
    if devices is not None:
        return [torch.device(d) for d in devices]
    if mesh is not None:
        ranks = mesh.mesh.reshape(-1).tolist()
        if mesh.device_type == "cuda":
            count = torch.cuda.device_count()
            return [torch.device("cuda", r % count) for r in ranks]
        return [torch.device(mesh.device_type) for _ in ranks]
    resolve_device("cuda")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _put(x: torch.Tensor, dev: torch.device) -> torch.Tensor:
    return x if x.device == dev else to_device(x, dev)


def _run_splitters(cmp_runs, num: int, oversample: int):
    """Global splitter tuples for a ``num``-way partition of k sorted runs:
    evenly spaced per-run quantile samples of the compare lanes, taken on
    each run's device and copied to the host once a run, pooled and
    lex-sorted there (a few k*oversample rows), then ``num - 1`` evenly
    spaced picks as host arrays. The splitters only steer *balance*;
    correctness never depends on them, because the per-run boundaries are
    exact searchsorted positions."""
    samples = [[] for _ in cmp_runs[0]]
    for cmp_r in cmp_runs:
        n_r = int(cmp_r[0].shape[0])
        if n_r == 0:
            continue
        pos = np.minimum(np.arange(oversample) * max(1, n_r // oversample),
                         n_r - 1)
        idx = torch.as_tensor(pos, device=cmp_r[0].device)
        rows = torch.stack([_bits(lane)[idx] for lane in cmp_r]).cpu().numpy()
        for i, lane in enumerate(cmp_r):
            samples[i].append(rows[i].view(_NP_DTYPES[lane.dtype]))
    pooled = [np.concatenate(s) for s in samples]
    order = np.lexsort(tuple(reversed(pooled)))
    pooled = [p[order] for p in pooled]
    take = [(d + 1) * len(order) // num for d in range(num - 1)]
    return [p[take] for p in pooled]


def _ingest_runs(keys, devs, *, algorithm, on_overflow, store, supervisor,
                 need_manifest):
    """Stage 1: row-shard ``keys`` into one chunk a destination, sort each
    on its device (``pipeline.ingest._ingest_chunk``: the run store's
    resume, manifests and ``on_overflow``). Returns ``(runs,
    manifests)``."""
    from ..pipeline.validate import host, keys_digest
    from ..pipeline.ingest import _ingest_chunk
    n = int(keys.shape[0])
    b = -(-n // len(devs))
    runs, manifests = [], []
    for d, start in enumerate(range(0, n, b)):
        part = keys[start:start + b]
        digest = None
        if store is not None and not isinstance(part, torch.Tensor):
            digest = keys_digest(host(part))   # the host slice, no copy back
        run, man = _ingest_chunk(
            to_device(part, devs[d]), d, digest, algorithm=algorithm,
            capacity=int(part.shape[0]), on_overflow=on_overflow,
            store=store, supervisor=supervisor, need_manifest=need_manifest,
            device=devs[d])
        runs.append(run)
        manifests.append(man)
    return runs, manifests


def _exchange(lanes_rs, cmp_rs, devs, oversample):
    """Stage 2: the exact-count exchange of whole sorted sub-runs. Each
    run's destination boundaries are exact ``lex_searchsorted`` positions
    of the pooled splitters over its compare lanes, so destination d
    receives precisely its key range as up to k contiguous sorted sub-runs.
    Returns one ``(sub_lanes, sub_cmps)`` a destination, on its device."""
    num = len(devs)
    if num == 1 or len(lanes_rs) == 1:
        bnds = [[0] + [int(r[0].shape[0])] * num for r in lanes_rs]
    else:
        splitters = _run_splitters(cmp_rs, num, oversample)
        bnds = []
        for cmp_r, r in zip(cmp_rs, lanes_rs):
            dev = cmp_r[0].device
            pos = lex_searchsorted(cmp_r, [to_device(s, dev)
                                           for s in splitters], side="right")
            bnds.append([0] + pos.cpu().tolist() + [int(r[0].shape[0])])
    per_dest = []
    for d in range(num):
        dev = devs[d]
        sub_lanes, sub_cmps = [], []
        for bnd, lanes, cmps in zip(bnds, lanes_rs, cmp_rs):
            lo, hi = bnd[d], bnd[d + 1]
            if hi <= lo:
                continue
            sub_lanes.append(tuple(_put(x[lo:hi], dev) for x in lanes))
            sub_cmps.append(tuple(_put(c[lo:hi], dev) for c in cmps))
        per_dest.append((sub_lanes, sub_cmps))
    return per_dest


def distributed_chunked_sort_lex(keys, mesh=None, axis: str = "data",
                                 devices=None, algorithm: str = "pallas",
                                 capacity: int | None = None,
                                 store=None, supervisor=None,
                                 validate: str = "off",
                                 on_overflow: str = "raise",
                                 merge_engine: str = "auto",
                                 oversample: int = 8,
                                 shard_store=None,
                                 gather: bool | None = None):
    """Out-of-core mesh sort of packed shortlex words — the MPI follow-up's
    bucket -> distribute -> merge-across-ranks shape composed from the
    pipeline and kernel tiers, one process placing work on explicit
    devices:

      1. **chunk-per-device ingest**: row-shard ``keys`` into one chunk per
         destination, copy each to its device and sort it there
         (``pipeline.ingest._ingest_chunk``: the ``RunStore`` resume,
         manifests and ``on_overflow``) into sorted runs;
      2. **one exact-count exchange of whole runs** (supervisor stage
         ``'run_exchange'``): splitters from pooled per-run quantile
         samples, each run's destination boundaries exact searchsorted
         positions, so counts come from the boundaries and nothing can be
         silently lost;
      3. **streaming combine** (stage ``'streaming_combine'`` inside
         ``pipeline.merge.merge_runs``): each destination merges its
         sub-runs in ONE k-way pass (B6; B5's rounds under
         ``merge_engine='tournament'``); the destinations in order are the
         global sort.

    ``keys``: packed ``(n, lanes)`` uint32 words, numpy or a tensor.
    Destinations: ``devices`` (a list of ``torch.device``; repeats allowed
    — ``[torch.device("cuda", 0)] * 8`` is eight destinations on one card),
    else one a rank of ``mesh`` (a ``DeviceMesh``) in its flat order, else
    every local card. ``capacity`` bounds each destination's combine input;
    ``on_overflow``: 'raise' (``CapacityOverflow`` with the required size),
    'retry' (double capacity and sample density until it fits; terminates
    at the worst-case destination count) or 'clip' (each overflowing
    destination keeps its ``capacity`` smallest elements, with a warning;
    conservation checks are skipped). ``validate``: 'off' | 'cheap' |
    'full' — ``pipeline.validate.check_chunked`` across ingest, exchange
    and combine ('full' adds content digests).

    **Sharded spill** (``shard_store``, a ``pipeline.shards.ShardStore``):
    each destination's merged output lands as an atomic shard the moment
    its combine completes, so (a) a killed job resumes at shard
    granularity (a stored shard whose count and summed sub-run digest match
    the re-exchanged destination *loads* instead of re-merging; torn or
    mismatched shards recompute), and (b) with ``validate != 'off'``
    ``check_sharded`` proves boundary order and conservation from the
    manifests alone. ``gather``: ``True`` (the default without a shard
    store) concatenates the destinations on ``devices[0]`` into a
    ``SortedRun``; ``False`` (the default *with* a shard store) skips the
    gather and returns the ``pipeline.shards.ShardedRun`` handle.

    With a ``supervisor`` carrying a ``SpeculationPolicy``, each
    destination combine runs through ``run_speculative``: a straggling
    merge gets a backup replica, the first completion wins, and the loser
    is discarded only after its output digest matches.
    """
    from ..pipeline import merge as merge_mod
    from ..pipeline.ingest import SortedRun, _run_from_arrays
    from ..pipeline.manifest import RunManifest
    from ..pipeline.validate import (ValidationError, check_chunked,
                                     check_lanes_sorted, check_run,
                                     check_sharded, multiset_digest)
    from ..checkpoint.manager import CorruptSnapshotError
    from ..runtime.failure import CapacityOverflow
    if on_overflow not in ("raise", "retry", "clip"):
        raise ValueError(f"unknown on_overflow policy {on_overflow!r}")
    if validate not in ("off", "cheap", "full"):
        raise ValueError("validate must be one of ('off', 'cheap', 'full')")
    if gather is None:
        gather = shard_store is None
    if not gather and shard_store is None:
        raise ValueError("gather=False requires a shard_store to spill to")
    devs = _chunk_devices(mesh, axis, devices)
    num = len(devs)
    if not isinstance(keys, torch.Tensor):
        keys = np.asarray(keys, dtype=np.uint32)
    n = int(keys.shape[0])
    if n == 0:
        if not gather:
            from ..pipeline.shards import ShardedRun
            return ShardedRun(store=shard_store, manifests=())
        return SortedRun(
            lengths=torch.zeros(0, dtype=torch.int32, device=devs[0]),
            keys=to_device(np.zeros(tuple(keys.shape), np.uint32), devs[0]))

    # 1. chunk-per-device ingest
    runs, manifests = _ingest_runs(
        keys, devs, algorithm=algorithm, on_overflow=on_overflow,
        store=store, supervisor=supervisor, need_manifest=validate != "off")
    lanes_rs = [r.lanes() for r in runs]
    cmp_rs = [r.cmp_lanes() for r in runs]

    # 2. exact-count exchange of whole sorted sub-runs
    while True:
        if supervisor is not None:
            per_dest = supervisor.run_stage("run_exchange", _exchange,
                                            lanes_rs, cmp_rs, devs,
                                            oversample)
        else:
            per_dest = _exchange(lanes_rs, cmp_rs, devs, oversample)
        incoming = [sum(int(s[0].shape[0]) for s in sub)
                    for sub, _ in per_dest]
        worst = max(incoming)
        if capacity is None or worst <= capacity:
            clipped = False
            break
        if on_overflow == "raise":
            raise CapacityOverflow(
                f"run exchange: destination needs {worst} > capacity "
                f"{capacity}", capacity, required=worst)
        if on_overflow == "clip":
            clipped = True
            break
        # retry rebalances as well as grows: denser samples usually shrink
        # the worst destination, and the capacity doubling guarantees the
        # loop ends even under unsplittable skew (duplicate keys)
        new_cap = min(capacity * 2, n)
        log.warning("run exchange overflow (worst destination %d): "
                    "capacity %d -> %d, oversample %d -> %d (retry)",
                    worst, capacity, new_cap, oversample, oversample * 2)
        capacity = new_cap
        oversample *= 2

    # 3. one streaming k-way combine per destination — each output spilled
    # as an atomic shard (with a shard_store) the moment it lands, so a
    # kill between destinations loses only the one in flight
    arity = len(lanes_rs[0])
    speculative = (supervisor is not None
                   and getattr(supervisor, "speculation", None) is not None)
    merged_dests = []        # (gather path) per-destination lane tuples
    shard_manifests = []     # (spill path) destination-ordered manifests
    for d, (sub_lanes, sub_cmps) in enumerate(per_dest):
        dev = devs[d]
        # the shard's identity from the exchange alone: incoming count +
        # summed sub-run key digest (additive, so the merged output's
        # digest is the sum — no merge needed to know what "done" is)
        want_digest = None
        if shard_store is not None:
            want_digest = sum(multiset_digest(s[1:]) for s in sub_lanes) \
                % (1 << 64)

        merged = None
        if shard_store is not None:
            try:
                man_d = shard_store.manifest(d)
            except CorruptSnapshotError as e:
                log.warning("shard store: shard %d manifest unreadable "
                            "(%s) — recomputing", d, e)
                man_d = None
            if (man_d is not None and man_d.count == incoming[d]
                    and man_d.digest == want_digest):
                try:
                    loaded = _run_from_arrays(*shard_store.load(d, dev),
                                              device=dev)
                    if validate != "off":
                        check_run(loaded, man_d, mode=validate)
                    elif int(loaded.lengths.shape[0]) != man_d.count:
                        raise ValidationError(
                            f"shard {d}: loaded {int(loaded.lengths.shape[0])} "
                            f"row(s) but manifest records {man_d.count}")
                except (CorruptSnapshotError, ValidationError) as e:
                    log.warning("shard store: shard %d failed its load "
                                "gate (%s) — recomputing", d, e)
                    shard_store.drop(d)
                else:
                    merged = loaded.lanes()
                    shard_manifests.append(man_d)
            elif man_d is not None:
                log.warning("shard store: shard %d manifest does not match "
                            "the exchanged destination (stale or clipped "
                            "shard) — recomputing", d)

        if merged is None:
            if not sub_lanes:
                merged = (torch.zeros(0, dtype=torch.int32, device=dev),
                          *(to_device(np.zeros(0, np.uint32), dev)
                            for _ in range(arity - 1)))
            elif speculative:
                # the backup replica re-runs the same pure combine; the
                # inner merge skips its own stage probe so the speculative
                # wrapper owns the injector and retry bookkeeping
                merged = supervisor.run_speculative(
                    "streaming_combine",
                    lambda sl=sub_lanes, sc=sub_cmps: merge_mod.merge_runs(
                        sl, engine=merge_engine, cmp_runs=sc,
                        supervisor=None),
                    digest_of=lambda lanes: multiset_digest(list(lanes)))
            else:
                merged = merge_mod.merge_runs(
                    sub_lanes, engine=merge_engine, cmp_runs=sub_cmps,
                    supervisor=supervisor)
            if clipped and incoming[d] > capacity:
                log.warning("run exchange overflow: destination %d clipped "
                            "%d element(s) past capacity %d", d,
                            incoming[d] - capacity, capacity)
                merged = tuple(x[:capacity] for x in merged)
            if shard_store is not None:
                run_d = SortedRun.from_lanes(merged)
                man_d = RunManifest.from_run(run_d, d)
                shard_store.put(man_d, run_d)
                shard_manifests.append(man_d)
        merged_dests.append(merged)

    if shard_store is not None and validate != "off":
        if clipped:
            # conservation cannot hold for a clipped output; still prove
            # the shards concatenate in order (each is internally sorted —
            # its own merge or load gate proved that)
            occ = [m for m in shard_manifests if m.count]
            for a, b in zip(occ, occ[1:]):
                if tuple(a.max_key) > tuple(b.min_key):
                    raise ValidationError(
                        f"shard boundary disorder: shard {a.chunk_id} max "
                        f"key {a.max_key} > shard {b.chunk_id} min key "
                        f"{b.min_key}")
        else:
            check_sharded(manifests, shard_manifests, mode=validate)

    if not gather:
        from ..pipeline.shards import ShardedRun
        return ShardedRun(store=shard_store,
                          manifests=tuple(shard_manifests))

    # destinations live on their own devices; the result gathers on the
    # first destination's device
    home = devs[0]
    occupied = [m for m in merged_dests if int(m[0].shape[0])]
    if occupied:
        out = tuple(_cat([_put(m[i], home) for m in occupied])
                    for i in range(arity))
    else:
        out = tuple(merged_dests[0])
    result = SortedRun.from_lanes(out)

    if validate != "off":
        if clipped:
            check_lanes_sorted(out, what="distributed_chunked output")
        else:
            check_chunked(runs, manifests, result, mode=validate)
    return result
