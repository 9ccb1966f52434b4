"""B6: one-launch k-way merge of sorted runs — a hand-written CUDA kernel
(``csrc/kway.cu``) and its plain PyTorch version, with the torch tier of the
same contract; the counterpart of ``repro.kernels.kway_kernel``.

  1. **k-way split** (torch glue): :func:`kway_ranks` gives every element
     its merge-path rank by a key tournament — rounds of pairwise
     ``keypack.merge_take_packed`` over the compare lanes and a
     source-index lane, then one inverse-permutation scatter. Ties rank by
     run index, then in-run index. One ``torch.searchsorted`` of each run's
     ranks over the block bounds turns them into the cursor matrix
     (:func:`kway_cursors`): run ``r``'s segment of output block ``j``
     starts at ``cursors[r, j]`` of the concatenated runs.
  2. **Per-block merge** (:func:`kway_merge`): block ``j``'s k segments hold
     exactly ``block`` elements together, so they are staged contiguously
     into one ``block``-wide window of the compare lanes and the source
     index, the window is sorted with B2's network, and every data lane is
     copied from its source index. Shared memory does not grow with k; the
     largest k per launch is :data:`MAX_RUNS`.

As in B5 the window carries the compare lanes only (an order-preserving
refinement of the tuple) and the index breaks the remaining ties, so the
result is the stable k-way merge, bit for bit that of
:func:`merge_runs_kway_take` — the torch tier: one stable sort over the
compare lanes' order bits (source order breaking ties), one gather per
lane.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from ._build import Kernel
from .bitonic_kernel import bitonic_rows_lex_plain
from .keypack import merge_take_packed, packed_cmp_lanes
from .lex import as_bits, codes_mask, from_bits, order_view, sentinel_bits
from .runmerge_kernel import (_INDEX_FILL, MAX_CMP_LANES, check_block,
                              check_runs, window_codes)

__all__ = ["KERNEL", "DEFAULT_KWAY_BLOCK", "MAX_RUNS", "kway_ranks",
           "kway_cursors", "kway_operands", "kway_merge", "kway_merge_plain",
           "merge_runs_kway_take", "merge_runs_kway_kernel"]

KERNEL = Kernel("merge_runs_kway", "kway.cu", "kway_merge_lex",
                [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int,
                                         ctypes.c_uint] + [ctypes.c_int] * 4,
                replaces="src/repro/kernels/kway_kernel.py:147")

DEFAULT_KWAY_BLOCK = 256
# runs one launch merges: each CTA scans its column of the cursor matrix
# with one thread per run, and a CTA has at most 1024 threads
MAX_RUNS = 1024


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


def _concat(runs_lanes, n_lanes: int, total: int, dev) -> torch.Tensor:
    """Lane ``l`` of every run, concatenated, as row ``l`` of a fresh
    ``(n_lanes, total)`` int32 tensor."""
    flat = torch.empty((n_lanes, total), dtype=torch.int32, device=dev)
    for l in range(n_lanes):
        torch.cat([as_bits(r[l]) for r in runs_lanes], out=flat[l])
    return flat


def kway_merge_plain(cmp: torch.Tensor, data: torch.Tensor,
                     cursors: torch.Tensor, codes: Sequence[int],
                     block: int) -> torch.Tensor:
    """The plain version: every block's window staged with gathers and
    sorted by B2's network (``bitonic_kernel.bitonic_rows_lex_plain``), then
    the data lanes gathered by the sorted index lane. Returns ``(n_arr,
    total)`` int32."""
    n_cmp, total = cmp.shape
    k = cursors.shape[0]
    cur = cursors.to(torch.int64)
    counts = cur[:, 1:] - cur[:, :-1]                         # (k, nblocks)
    offs = torch.cat([torch.zeros_like(counts[:1]),
                      counts.cumsum(0)]).T.contiguous()       # (nblocks, k+1)
    slot = torch.arange(block, device=cmp.device).expand(offs.shape[0], -1)
    run = torch.searchsorted(offs[:, :k].contiguous(), slot.contiguous(),
                             right=True) - 1
    src = cur.T[:-1].gather(1, run) + slot - offs.gather(1, run)
    valid = slot < offs[:, k:]
    src = torch.where(valid, src, 0)
    lanes = [torch.where(valid, cmp[l][src], sentinel_bits(codes[l]))
             for l in range(n_cmp)]
    idx = torch.where(valid, src, _INDEX_FILL).to(torch.int32)
    window = bitonic_rows_lex_plain(torch.stack(lanes + [idx]), codes)
    order = window[n_cmp].reshape(-1)[:total].to(torch.int64)
    return data[:, order]


def kway_merge(cmp: torch.Tensor, data: torch.Tensor, cursors: torch.Tensor,
               codes: Sequence[int], block: int) -> torch.Tensor:
    """Merge the k sorted runs concatenated in ``cmp`` ``(n_cmp, total)``
    (their compare lanes) and ``data`` ``(n_arr, total)`` (the lanes to
    merge), stacked int32, by the cursor matrix of :func:`kway_cursors`;
    ``codes`` the window's (``runmerge_kernel.window_codes``). Returns the
    merged ``(n_arr, total)`` int32 lanes. A CPU tensor runs the plain
    version; a CUDA tensor launches the kernel."""
    n_cmp, total = cmp.shape
    n_arr = data.shape[0]
    for t in (cmp, data):
        if (t.dtype != torch.int32 or t.dim() != 2 or not t.is_contiguous()
                or t.shape[1] != total):
            raise ValueError("kway_merge: expected contiguous stacked int32 "
                             f"lanes, got {tuple(t.shape)} {t.dtype}")
    if len(codes) != n_cmp + 1 or n_cmp > MAX_CMP_LANES:
        raise ValueError(f"kway_merge: need 1 to {MAX_CMP_LANES} compare "
                         "lanes and a code each plus the index lane's")
    k, nbounds = cursors.shape
    if not 1 <= k <= MAX_RUNS:
        raise ValueError(f"kway_merge: {k} runs; one launch merges 1 to "
                         f"{MAX_RUNS} (one thread per run scans the cursor "
                         "matrix)")
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
    32-bit tensors, any lengths) in one launch of the k-way kernel — the
    counterpart of ``merge_runs_kway_pallas``. ``n_cmp``/``max_values`` as
    in ``runmerge_kernel.merge_runs_lex_kernel``; ``block`` a power of two
    >= 128 (default 256). Empty runs drop; one run comes back as it is; more
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
    sorted runs: ``(cmp, data, cursors, codes)``."""
    cmp_runs = _cmp_runs(runs, n_cmp, max_values)
    codes = window_codes(cmp_runs[0])
    cursors = kway_cursors(kway_ranks(cmp_runs), block)
    total = sum(r[0].shape[0] for r in runs)
    dev = runs[0][0].device
    data = _concat(runs, len(runs[0]), total, dev)
    cmp = (data[:n_cmp] if n_cmp is not None
           else _concat(cmp_runs, len(cmp_runs[0]), total, dev))
    return cmp, data, cursors, codes
