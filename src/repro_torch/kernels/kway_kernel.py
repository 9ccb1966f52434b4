"""B6: one-launch k-way merge of sorted runs and its k-way split —
hand-written CUDA kernels (``csrc/kway.cu``) and their plain PyTorch
versions, with the torch tier of the same contract; the counterpart of
``repro.kernels.kway_kernel``.

  1. **k-way split** (:func:`kway_starts`): the cursor matrix ``(k, nblocks
     + 1)`` int32 — run ``r``'s segment of output block ``j`` starts at
     ``cursors[r, j]`` of the concatenated runs. It is the reference's key
     tournament: rounds of pairwise merges of adjacent segments of one
     ``(n_cmp + 1, total)`` stack (the compare lanes' order bits, then each
     element's flat source index), the lower segment always first, so ties
     fall by run index. Each round merges all its pairs at once by B5's
     algorithm (a co-rank split, then a merge of :data:`SPLIT_BLOCK`-slot
     blocks) on a plan the host builds from the run lengths alone
     (:func:`split_plan`); the last round writes the inverse permutation,
     and each run's cursors follow from its elements' ranks. On a CUDA
     device :data:`SPLIT_KERNEL` runs a round a call, two launches, the
     cursors with the last; :func:`kway_starts_plain` runs the same rounds
     pair by pair through ``runmerge_kernel``'s plain split and merge.
     :func:`kway_ranks` and :func:`kway_cursors` — the reference's split in
     torch, ``merge_take_packed`` rounds and a ``searchsorted`` a run —
     are the tests' oracle.
  2. **Gather** (:func:`kway_gather`, :data:`GATHER_KERNEL`): every run's
     lanes concatenated into stacked ``(lanes, total)`` int32 in one
     launch, from a table of lane addresses and strides uploaded with the
     split's plan in one copy (:func:`kway_gather_plain`: ``torch.cat`` a
     lane).
  3. **Per-block merge** (:func:`kway_merge`): block ``j``'s k segments
     hold exactly ``block`` elements together; they are staged one after
     the other into a tile and merged there by ceil(log2 k) rounds of
     pairwise merges (the reference's in-block loser tree), b only where b
     < a strictly, so equal keys keep run order; then every data lane is
     copied out of the tile. :func:`kway_merge_plain` runs the same rounds
     over every block at once. Shared memory does not grow with k; the
     largest k per launch is :data:`MAX_RUNS`.

Only the compare lanes are compared (an order-preserving refinement of the
tuple), so the result is the stable k-way merge, bit for bit that of
:func:`merge_runs_kway_take` — the torch tier: one stable sort over the
compare lanes' order bits (source order breaking ties), one gather per
lane.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence

import numpy as np
import torch

from ._build import Kernel
from .keypack import merge_take_packed, packed_cmp_lanes
from .lex import (U32, as_bits, codes_mask, from_bits, lex_gt_keys,
                  order_keys, order_view, to_order_bits)
from .runmerge_kernel import (_DTYPES, _INDEX_FILL, MAX_CMP_LANES,
                              check_block, check_runs, cmp_codes,
                              merge_path_starts_plain, runmerge_plain)

__all__ = ["KERNEL", "SPLIT_KERNEL", "GATHER_KERNEL", "DEFAULT_KWAY_BLOCK",
           "MAX_RUNS", "SPLIT_BLOCK", "SplitRound", "split_plan",
           "kway_starts", "kway_starts_plain", "kway_gather",
           "kway_gather_plain", "kway_ranks", "kway_cursors",
           "kway_operands", "kway_merge", "kway_merge_plain",
           "merge_runs_kway_take", "merge_runs_kway_kernel"]

KERNEL = Kernel("merge_runs_kway", "kway.cu", "kway_merge_lex",
                [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int,
                                         ctypes.c_uint] + [ctypes.c_int] * 4,
                replaces="src/repro/kernels/kway_kernel.py:147")
# the split, which the reference computes in jnp inside the TPU kernel's
# jit: one call a tournament round
SPLIT_KERNEL = Kernel("kway_split", "kway.cu", "kway_split_round",
                      [ctypes.c_void_p] * 6
                      + [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                         ctypes.c_uint, ctypes.c_int, ctypes.c_int,
                         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                         ctypes.c_int, ctypes.c_int],
                      replaces="src/repro/kernels/kway_kernel.py:226")
# the concatenation of the runs' lanes, the same jit's jnp
GATHER_KERNEL = Kernel("kway_gather", "kway.cu", "kway_gather_lanes",
                       [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3,
                       replaces="src/repro/kernels/kway_kernel.py:238")

DEFAULT_KWAY_BLOCK = 256
# runs one launch merges: each CTA holds two ints a run in shared memory
# beside its tile, and the split's cursor pass the runs' bases
MAX_RUNS = 1024
# the output block of a split round's merges, whatever the merge's block
SPLIT_BLOCK = 256
_WORDS = (torch.int32, torch.uint32, torch.float32)


def kway_ranks(cmp_runs) -> list:
    """Merge-path rank of every element of every sorted run: one int64
    tensor per run, together a permutation of ``[0, total)``.
    ``cmp_runs[r]`` is run r's compare-lane list; compare-equal elements
    order by run index, then in-run index. A key tournament of
    ``merge_take_packed`` rounds (the lower run always the left operand, so
    the a-before-b tie rule composes along the tree) over the compare lanes
    and each element's flat source index, then the inverse permutation."""
    cmp_runs = [list(c) for c in cmp_runs]
    ns = [c[0].shape[0] for c in cmp_runs]
    dev = cmp_runs[0][0].device
    total = sum(ns)
    if len(cmp_runs) == 1:
        return [torch.arange(total, device=dev)]
    nc = len(cmp_runs[0])
    bases = [sum(ns[:r]) for r in range(len(ns))]
    ext = [c + [torch.arange(b, b + n, dtype=torch.int32, device=dev)]
           for c, b, n in zip(cmp_runs, bases, ns)]
    while len(ext) > 1:
        nxt = [merge_take_packed(ext[j], ext[j + 1], n_cmp=nc)
               for j in range(0, len(ext) - 1, 2)]
        if len(ext) % 2:
            nxt.append(ext[-1])
        ext = nxt
    ranks = torch.empty(total, dtype=torch.int64, device=dev)
    ranks[ext[0][nc].to(torch.int64)] = torch.arange(total, device=dev)
    return [ranks[b:b + n] for b, n in zip(bases, ns)]


def kway_cursors(ranks, block: int) -> torch.Tensor:
    """The cursor matrix ``(k, nblocks + 1)`` int32 from :func:`kway_ranks`:
    run r's segment of output block j is ``[cursors[r, j], cursors[r, j +
    1])`` of the concatenated runs."""
    total = sum(r.shape[0] for r in ranks)
    dev = ranks[0].device
    bounds = torch.arange(-(-total // block) + 1, device=dev) * block
    base, rows = 0, []
    for r in ranks:
        rows.append(base + torch.searchsorted(r, bounds, side="left"))
        base += r.shape[0]
    return torch.stack(rows).to(torch.int32)


class SplitRound(NamedTuple):
    """One round of the k-way split: its pairs ``(off, na, nb)`` of adjacent
    segments of the stack (a at ``[off, off + na)``, b the ``nb`` elements
    after it; an odd last segment pairs with an empty one), and ``first``,
    the prefix of the pairs' ``SPLIT_BLOCK``-slot output blocks."""

    pairs: tuple
    first: tuple


def split_plan(ns: Sequence[int], block: int = SPLIT_BLOCK) -> list:
    """The rounds of the k-way split of runs of lengths ``ns``, laid end to
    end: ``max(1, ceil(log2 k))`` :class:`SplitRound`s, each merging the
    previous round's segments in adjacent pairs."""
    segs, off = [], 0
    for n in ns:
        segs.append((off, int(n)))
        off += int(n)
    rounds = []
    while True:
        pairs = tuple((segs[i][0], segs[i][1],
                       segs[i + 1][1] if i + 1 < len(segs) else 0)
                      for i in range(0, len(segs), 2))
        first = [0]
        for _, na, nb in pairs:
            first.append(first[-1] + -(-(na + nb) // block))
        rounds.append(SplitRound(pairs, tuple(first)))
        segs = [(o, na + nb) for o, na, nb in pairs]
        if len(segs) == 1:
            return rounds


def _bases(ns) -> list:
    out = [0]
    for n in ns:
        out.append(out[-1] + int(n))
    return out


def _order_bits(cmp: torch.Tensor, codes: Sequence[int]) -> torch.Tensor:
    """Stacked lanes' order bits (``lex.to_order_bits``) as int32 bits."""
    return torch.stack([as_bits(to_order_bits(from_bits(lane, _DTYPES[c])))
                        for lane, c in zip(cmp, codes)])


def _cursors_from_ranks(rank: torch.Tensor, bases: Sequence[int],
                        block: int) -> torch.Tensor:
    """The cursor kernel's rule: element i of run r (rank q, the previous
    element of its run ranked q') is the cursor of each block j with q' <
    j * block <= q, and the run's end the cursor of each j past its last
    rank."""
    dev = rank.device
    k, total = len(bases) - 1, int(bases[-1])
    nblocks = -(-total // block)
    b = torch.tensor(bases, dtype=torch.int64, device=dev)
    if total == 0:
        return b[:k, None].to(torch.int32)
    cursors = torch.empty((k, nblocks + 1), dtype=torch.int64, device=dev)

    def fill(rows, lo, hi, values):
        cnt = (hi - lo + 1).clamp(min=0)
        at = torch.repeat_interleave(torch.arange(len(cnt), device=dev), cnt)
        step = torch.arange(at.shape[0], device=dev) - (cnt.cumsum(0)
                                                        - cnt)[at]
        cursors[rows[at], lo[at] + step] = values[at]

    i = torch.arange(total, device=dev)
    run = torch.searchsorted(b[:k], i, right=True) - 1
    prev = rank[(i - 1).clamp(min=0)]
    fill(run, torch.where(i == b[run], 0, prev // block + 1), rank // block,
         i)
    ends, n_r = b[1:], b[1:] - b[:k]
    last = rank[(ends - 1).clamp(0, total - 1)]
    fill(torch.arange(k, device=dev),
         torch.where(n_r > 0, last // block + 1, 0),
         torch.full((k,), nblocks, device=dev), ends)
    return cursors.to(torch.int32)


def kway_starts_plain(cmp: torch.Tensor, ns: Sequence[int],
                      codes: Sequence[int], block: int) -> torch.Tensor:
    """The plain split, the kernels' rounds pair by pair: the stack of the
    compare lanes' order bits and the flat index, every pair of each round
    of :func:`split_plan` merged by ``runmerge_kernel``'s plain split and
    merge (``merge_path_starts_plain``, ``runmerge_plain``) at
    :data:`SPLIT_BLOCK`, then the inverse permutation and the cursors by
    the kernel's rule. Returns ``(k, nblocks + 1)`` int32."""
    n_cmp, total = cmp.shape
    dev = cmp.device
    u32 = [U32] * n_cmp
    stack = torch.cat([_order_bits(cmp, codes),
                       torch.arange(total, dtype=torch.int32,
                                    device=dev)[None]])
    for rd in split_plan(ns):
        nxt = torch.empty_like(stack)
        for off, na, nb in rd.pairs:
            a = stack[:, off:off + na]
            b = stack[:, off + na:off + na + nb]
            starts = merge_path_starts_plain(a[:n_cmp], b[:n_cmp], u32,
                                             SPLIT_BLOCK)
            nxt[:, off:off + na + nb] = runmerge_plain(
                a[:n_cmp], b[:n_cmp], a, b, starts, u32, SPLIT_BLOCK)
        stack = nxt
    rank = torch.empty(total, dtype=torch.int64, device=dev)
    rank[stack[n_cmp].to(torch.int64)] = torch.arange(total, device=dev)
    return _cursors_from_ranks(rank, _bases(ns), block)


def _device_plan(device, rounds, bases, lanes=None):
    """The split's plan in one host-to-device copy: every round's table
    (``off``, ``na``, ``nb``, ``first``; ``csrc/kway.cu``), the runs'
    bases and, for the gather, the addresses of ``lanes`` (``lanes[r][l]``,
    1-D 32-bit tensors) and their strides. Returns the device tensor (kept
    alive by the caller while its launches are queued) and the addresses
    of each round's table, the bases, and the gather's two tables."""
    ints, at = [], []
    for rd in rounds:
        at.append(len(ints))
        for col in range(3):
            ints += [p[col] for p in rd.pairs]
        ints += rd.first
    bases_at = len(ints)
    ints += bases
    flat_lanes = [x for run in lanes or () for x in run]
    ptrs = [x.data_ptr() for x in flat_lanes]
    strides_at = len(ints)
    ints += [x.stride()[0] for x in flat_lanes]
    host = torch.empty(len(ptrs) + (len(ints) + 1) // 2, dtype=torch.int64,
                       pin_memory=True)
    flat = host.numpy()
    flat[:len(ptrs)] = ptrs
    flat[len(ptrs):].view(np.int32)[:len(ints)] = ints
    plan = host.to(device, non_blocking=True)
    words = plan.data_ptr() + 8 * len(ptrs)
    return plan, {"rounds": [words + 4 * a for a in at],
                  "bases": words + 4 * bases_at, "ptrs": plan.data_ptr(),
                  "strides": words + 4 * strides_at}


def _split_rounds(cmp, codes, rounds, addr, k: int, block: int):
    """Launch the split's rounds (:data:`SPLIT_KERNEL`, one call a round) on
    the device plan ``addr`` (:func:`_device_plan`); returns the cursors."""
    n_cmp, total = cmp.shape
    dev = cmp.device
    nblocks = -(-total // block)
    cursors = torch.empty((k, nblocks + 1), dtype=torch.int32, device=dev)
    rank = torch.empty(total, dtype=torch.int32, device=dev)
    # ping-pong stacks of the rounds between the first and the last
    bufs = torch.empty((min(2, len(rounds) - 1), n_cmp + 1, total),
                       dtype=torch.int32, device=dev)
    starts = torch.empty(2 * max(rd.first[-1] + len(rd.pairs)
                                 for rd in rounds),
                         dtype=torch.int32, device=dev)
    src, src_idx, mask = cmp.data_ptr(), None, codes_mask(codes)
    for t, rd in enumerate(rounds):
        last = t == len(rounds) - 1
        dst = None if last else bufs[t % 2]
        SPLIT_KERNEL(dev, src, src_idx, None if last else dst.data_ptr(),
                     rank.data_ptr() if last else None, starts.data_ptr(),
                     addr["rounds"][t], len(rd.pairs), rd.first[-1], n_cmp,
                     mask if t == 0 else 0, total, SPLIT_BLOCK,
                     addr["bases"] if last else None,
                     cursors.data_ptr() if last else None, k, nblocks, block)
        if not last:
            src, src_idx = dst.data_ptr(), dst[n_cmp].data_ptr()
    return cursors


def kway_starts(cmp: torch.Tensor, ns: Sequence[int], codes: Sequence[int],
                block: int) -> torch.Tensor:
    """The k-way split: the cursor matrix ``(k, nblocks + 1)`` int32 of the
    sorted runs of lengths ``ns`` concatenated in ``cmp`` — their stacked
    ``(n_cmp, total)`` int32 compare lanes, of ``codes`` — for ``block``-
    slot output blocks; ``kway_cursors(kway_ranks(...))`` bit for bit. A
    CPU tensor runs the plain version; a CUDA tensor launches the split's
    rounds (at most :data:`MAX_RUNS` runs)."""
    if (cmp.dtype != torch.int32 or cmp.dim() != 2
            or not cmp.is_contiguous()):
        raise ValueError("kway_starts: expected contiguous stacked int32 "
                         f"lanes, got {tuple(cmp.shape)} {cmp.dtype}")
    n_cmp, total = cmp.shape
    if len(codes) != n_cmp or not 1 <= n_cmp <= MAX_CMP_LANES:
        raise ValueError(f"kway_starts: need 1 to {MAX_CMP_LANES} compare "
                         "lanes and a code each")
    if not ns or sum(ns) != total or min(ns) < 0:
        raise ValueError("kway_starts: the run lengths must add up to the "
                         "lanes' length")
    if block < 1:
        raise ValueError("kway_starts: block must be positive")
    if cmp.device.type == "cpu":
        return kway_starts_plain(cmp, ns, codes, block)
    _check_device_runs("kway_starts", ns)
    if total == 0:
        return torch.zeros((len(ns), 1), dtype=torch.int32,
                           device=cmp.device)
    rounds = split_plan(ns)
    plan, addr = _device_plan(cmp.device, rounds, _bases(ns))
    return _split_rounds(cmp, codes, rounds, addr, len(ns), block)


def _word_lanes(runs_lanes) -> list:
    """Each run's lanes as 32-bit words: 32-bit lanes as they are, narrow
    ones widened (``lex.as_bits``)."""
    return [[x if x.dtype in _WORDS else as_bits(x) for x in r]
            for r in runs_lanes]


def kway_gather_plain(runs_lanes) -> torch.Tensor:
    """The gather's plain version: lane ``l`` of every run (equal-arity
    sequences of 1-D tensors), concatenated by ``torch.cat`` as row ``l``
    of a fresh ``(lanes, total)`` int32 tensor."""
    lanes = _word_lanes(runs_lanes)
    flat = torch.empty((len(lanes[0]), sum(r[0].shape[0] for r in lanes)),
                       dtype=torch.int32, device=lanes[0][0].device)
    for l in range(flat.shape[0]):
        torch.cat([as_bits(r[l]) for r in lanes], out=flat[l])
    return flat


def _gather(lanes, addr, total: int, dev) -> torch.Tensor:
    """One launch of :data:`GATHER_KERNEL` from the plan's lane tables."""
    n_lanes = len(lanes[0])
    out = torch.empty((n_lanes, total), dtype=torch.int32, device=dev)
    GATHER_KERNEL(dev, addr["ptrs"], addr["strides"], addr["bases"],
                  out.data_ptr(), n_lanes, len(lanes), total)
    return out


def _check_device_runs(what: str, ns) -> None:
    if len(ns) > MAX_RUNS:
        raise ValueError(f"{what}: {len(ns)} runs; the kernels take at most "
                         f"{MAX_RUNS}")
    if sum(ns) >= _INDEX_FILL:
        raise ValueError(f"{what}: runs of 2^31 - 1 elements or more")


def kway_gather(runs_lanes) -> torch.Tensor:
    """Lane ``l`` of every run concatenated as row ``l`` of a ``(lanes,
    total)`` int32 tensor (32-bit lanes' bits, narrow lanes widened). A CPU
    tensor runs the plain version; a CUDA tensor launches the gather on a
    table of the lanes' addresses (at most :data:`MAX_RUNS` runs)."""
    lanes = _word_lanes(runs_lanes)
    dev = lanes[0][0].device
    if dev.type == "cpu":
        return kway_gather_plain(lanes)
    ns = [r[0].shape[0] for r in lanes]
    _check_device_runs("kway_gather", ns)
    plan, addr = _device_plan(dev, [], _bases(ns), lanes)
    return _gather(lanes, addr, sum(ns), dev)


def kway_merge_plain(cmp: torch.Tensor, data: torch.Tensor,
                     cursors: torch.Tensor, codes: Sequence[int],
                     block: int) -> torch.Tensor:
    """The plain version, the kernel's steps over every block at once: each
    block's k segments in a tile one after the other, then the merge tree —
    round w merges runs ``[2mw, 2mw + w)`` and ``[2mw + w, 2mw + 2w)`` of
    the tile, each output's co-rank in its pair by a binary search over
    the compare lanes' order keys and its source b only where b < a
    strictly, moving tile positions — then the data lanes gathered by the
    final positions. Returns ``(n_arr, total)`` int32."""
    n_cmp = cmp.shape[0]
    k = cursors.shape[0]
    dev = cmp.device
    cur = cursors.to(torch.int64)
    counts = (cur[:, 1:] - cur[:, :-1]).T                     # (nblocks, k)
    offs = torch.cat([torch.zeros_like(counts[:, :1]), counts.cumsum(1)], 1)
    slot = torch.arange(block, device=dev).expand(offs.shape[0], -1)
    live = slot < offs[:, k:]
    run = (torch.searchsorted(offs[:, :k].contiguous(), slot.contiguous(),
                              right=True) - 1).clamp(0, k - 1)
    src = torch.where(live, cur[:, :-1].T.gather(1, run) + slot
                      - offs.gather(1, run), 0)
    keys = order_keys(cmp, codes)[:, src]            # (n_cmp, nblocks, B)
    perm = slot.contiguous()

    def less(p, q):                          # tile position p's key < q's
        def at(x):
            x = perm.gather(1, x.clamp(0, block - 1))
            return keys.gather(2, x.expand(n_cmp, -1, -1))
        return lex_gt_keys(at(q), at(p))

    w = 1
    while w < k:
        r_lo = run // (2 * w) * (2 * w)
        a_lo = offs.gather(1, r_lo)
        a_hi = offs.gather(1, (r_lo + w).clamp(max=k))
        ca, cb = a_hi - a_lo, offs.gather(1, (r_lo + 2 * w).clamp(max=k)) - a_hi
        d = slot - a_lo
        hi = torch.minimum(d, ca)
        lo = torch.minimum((d - cb).clamp(min=0), hi)
        for _ in range(block.bit_length() + 1):
            mid = (lo + hi) >> 1
            b_first = less(a_hi + d - 1 - mid, a_lo + mid)
            active = lo < hi
            hi = torch.where(active & b_first, mid, hi)
            lo = torch.where(active & ~b_first, mid + 1, lo)
        j = d - lo
        take_b = (j < cb) & ((lo >= ca) | less(a_hi + j, a_lo + lo))
        pos = torch.where(take_b, a_hi + j, a_lo + lo)
        perm = torch.where(live, perm.gather(1, pos.clamp(0, block - 1)),
                           perm)
        w *= 2
    return data[:, src.gather(1, perm)[live]]


def kway_merge(cmp: torch.Tensor, data: torch.Tensor, cursors: torch.Tensor,
               codes: Sequence[int], block: int) -> torch.Tensor:
    """Merge the k sorted runs concatenated in ``cmp`` ``(n_cmp, total)``
    (their compare lanes) and ``data`` ``(n_arr, total)`` (the lanes to
    merge), stacked int32, by the cursor matrix of :func:`kway_starts`;
    ``codes`` the compare lanes' (``runmerge_kernel.cmp_codes``). Returns
    the merged ``(n_arr, total)`` int32 lanes. A CPU tensor runs the plain
    version; a CUDA tensor launches the kernel."""
    n_cmp, total = cmp.shape
    n_arr = data.shape[0]
    for t in (cmp, data):
        if (t.dtype != torch.int32 or t.dim() != 2 or not t.is_contiguous()
                or t.shape[1] != total):
            raise ValueError("kway_merge: expected contiguous stacked int32 "
                             f"lanes, got {tuple(t.shape)} {t.dtype}")
    if len(codes) != n_cmp or n_cmp > MAX_CMP_LANES:
        raise ValueError(f"kway_merge: need 1 to {MAX_CMP_LANES} compare "
                         "lanes and a code each")
    k, nbounds = cursors.shape
    if not 1 <= k <= MAX_RUNS:
        raise ValueError(f"kway_merge: {k} runs; one launch merges 1 to "
                         f"{MAX_RUNS}")
    if total >= _INDEX_FILL:
        raise ValueError("kway_merge: runs of 2^31 - 1 elements or more")
    if (nbounds - 1) * block < total:
        raise ValueError("kway_merge: the cursors do not cover the runs")
    if cmp.device.type == "cpu":
        return kway_merge_plain(cmp, data, cursors, codes, block)
    out = torch.empty((n_arr, total), dtype=torch.int32, device=cmp.device)
    cursors = cursors.to(torch.int32).contiguous()
    KERNEL(cmp.device, cmp.data_ptr(), data.data_ptr(), out.data_ptr(),
           cursors.data_ptr(), n_cmp, n_arr, codes_mask(codes), total, k,
           nbounds - 1, block)
    return out


def _cmp_runs(runs, n_cmp, max_values):
    if n_cmp is None:
        return [packed_cmp_lanes(list(r), max_values) for r in runs]
    return [list(r[:n_cmp]) for r in runs]


def merge_runs_kway_take(runs, n_cmp: int | None = None,
                         max_values=None) -> tuple:
    """The torch tier: the merge permutation from a stable sort of the
    concatenated compare lanes' order bits — least significant pair of
    lanes first, two lanes to an int64 key, so source order (run index,
    then in-run index) breaks the remaining ties — then one gather per
    lane. ``repro.kernels.kway_kernel.merge_runs_kway_take`` bit for bit."""
    runs = check_runs(runs)
    cmp_runs = _cmp_runs(runs, n_cmp, max_values)
    nc = len(cmp_runs[0])
    keys = [torch.cat([order_view(c[i]) for c in cmp_runs]).to(torch.int64)
            for i in range(nc)]
    perm = None
    for i in reversed(range(0, nc, 2)):
        key = keys[i]
        if i + 1 < nc:
            key = (key << 32) | (keys[i + 1] + (1 << 31))  # low lane unsigned
        if perm is not None:
            key = key[perm]
        idx = torch.sort(key, stable=True).indices
        perm = idx if perm is None else perm[idx]
    return tuple(from_bits(torch.cat([as_bits(r[i]) for r in runs])[perm],
                           runs[0][i].dtype) for i in range(len(runs[0])))


def merge_runs_kway_kernel(runs, n_cmp: int | None = None, max_values=None,
                           block: int | None = None) -> tuple:
    """Merge k sorted lex-tuple runs (equal-arity tuples of parallel 1-D
    32-bit tensors, any lengths) with the k-way kernel — the counterpart
    of ``merge_runs_kway_pallas``: on a CUDA device one plan upload, one
    gather of the lanes, the split's ceil(log2 k) rounds and one launch of
    the merge. ``n_cmp``/``max_values`` as in
    ``runmerge_kernel.merge_runs_lex_kernel``; ``block`` a power of two >=
    128 (default 256). Empty runs drop; one run comes back as it is; more
    than :data:`MAX_RUNS` non-empty runs raise."""
    runs = check_runs(runs)
    block = check_block(DEFAULT_KWAY_BLOCK if block is None else block)
    nonempty = [r for r in runs if r[0].shape[0]]
    if not nonempty:
        return runs[0]
    if len(nonempty) == 1:
        return nonempty[0]
    if len(nonempty) > MAX_RUNS:
        raise ValueError(f"{len(nonempty)} runs; one launch of the k-way "
                         f"kernel merges at most {MAX_RUNS}")
    out = kway_merge(*kway_operands(nonempty, n_cmp, max_values, block),
                     block)
    return tuple(from_bits(out[l], runs[0][l].dtype)
                 for l in range(len(runs[0])))


def kway_operands(runs, n_cmp: int | None = None, max_values=None,
                  block: int = DEFAULT_KWAY_BLOCK):
    """The arguments of :func:`kway_merge` but ``block`` for non-empty
    sorted runs: ``(cmp, data, cursors, codes)``. On a CUDA device the
    lanes are gathered and the cursors split on the device from one plan
    upload; on the CPU by the plain versions."""
    cmp_runs = _cmp_runs(runs, n_cmp, max_values)
    codes = cmp_codes(cmp_runs[0])
    nc, n_arr = len(codes), len(runs[0])
    ns = [r[0].shape[0] for r in runs]
    total = sum(ns)
    dev = runs[0][0].device
    lanes = _word_lanes(r if n_cmp is not None else list(c) + list(r)
                        for r, c in zip(runs, cmp_runs))
    if dev.type == "cpu":
        flat = kway_gather_plain(lanes)
        cursors = kway_starts_plain(flat[:nc], ns, codes, block)
    else:
        _check_device_runs("kway_operands", ns)
        rounds = split_plan(ns)
        plan, addr = _device_plan(dev, rounds, _bases(ns), lanes)
        flat = _gather(lanes, addr, total, dev)
        cursors = _split_rounds(flat[:nc], codes, rounds, addr, len(ns),
                                block)
    return flat[:nc], flat[len(lanes[0]) - n_arr:], cursors, codes
