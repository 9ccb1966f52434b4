#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout, on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It imports nothing of ``jax`` or ``repro``. Phases, each fatal on failure:

  1. build — compile the seven CUDA kernels from ``src/repro_torch/kernels/
     csrc`` with ``nvcc`` for ``sm_90a``, one process per source, and print
     ``-Xptxas -v``'s registers, shared memory and spills per kernel;
  2. kernels — run every kernel at the shapes its path gives it, on the
     path's data and on adversarial inputs (sentinel-colliding uint32,
     duplicate-heavy, float32 NaN/±0/±inf with a payload lane; for the run
     merges also empty and one-element runs and the 18-array tuple of
     32-byte words), require its bits to equal its plain PyTorch version's
     on the card and its output to be in order (for the row sorts a chain
     of stable ``torch.sort`` passes is the independent check; for the run
     merges the torch tier and the total-order contract), and time kernel,
     plain version and library call or torch tier. The merge kernel (B4)
     also runs at every power-of-two block from 1 to its shared-memory cap,
     at offsets 0 and ``block``, for 1, 2, 3, 4, 5, 8 and 9 lanes of each
     code and fill. The merge-path kernel (B5) runs at the last tournament round
     of DS2 chunked at 4096 words, the k-way kernel (B6) at DS2's 57 runs;
  3. main path — sort a 500-word chunk (OETS tier), a 3,000-word chunk
     (bitonic tier) and the paper's DS1 and DS2 (blocksort: bitonic + merge)
     through ``bucketed_sort_words`` and ``sorted_packed``; then the run
     tier: ``chunked_sort_words`` of DS2 at chunk 4096 with the k-way merge
     and with the tournament, and ``chunked_sort_packed`` of 1,048,576
     synthetic words at chunk 16,384 with ``validate='full'``. Every launch
     counter is set to 0 just before each run and read just after; each
     result must equal Python's shortlex ``sorted``, DS1's packed lanes must
     equal the plain path's on the CPU, and every kernel must have run on
     its path;
  4. partition and the repaired sorts — ``partition_rows`` (B7) on DS2's
     first packed lane as (8, 28,750) with 7 and 127 splitters, on the
     million-word corpus's first lane as (64, 16,384) with 127, and on
     DS2's byte lengths (1, 230,000) with splitters 1..16, whose counts
     must equal B3's histogram; ``sort`` of 230,000 int8, int16, uint8 and
     uint16 keys (blocksort: B2, B4) and ``sort_lex`` through the packed
     engine on two bounded int32 lanes and on a float32 lane of NaN
     payloads and ±0 beside an int32 lane, each equal to the CPU port's
     result. The counters are read around those calls; then B7 is held to
     its plain version bit for bit on each input and on adversarial ones
     (int32 extremes, keys equal to splitters, duplicated and unsorted
     splitters, none, C = 130 with R = 1, uint32 keys past 2^31, and a
     sweep of splitter counts from 0 to ``MAX_SPLITTERS`` at ragged column
     counts), and timed beside its plain version and ``torch.bucketize``
     plus a scatter-add.

Every kernel row carries ``ms`` (CUDA events around 20 back-to-back calls,
so the host's time per call counts where it is longer) and ``device_ms``
(the device's own time per call, from ``torch.profiler`` over the same
calls; ``device_ms_source`` says whether the profiler or the CUDA-graph
fallback gave it).

Then it prints the card's name and power limit as ``nvidia-smi`` gives them,
one JSON line with every kernel's numbers, and last
``{"ok": true, "device": {...}}``. It exits non-zero, printing no result,
when there is no card or any check fails.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA's data sheet): HBM3 bandwidth, and the float32 rate
# outside the tensor cores — the table's only non-tensor rate, so compares
# counted against it give a lower bound on their time
HBM_BYTES_PER_S = 3.35e12
NON_TENSOR_OPS_PER_S = 67e12
KERNEL_ITERS = 20
PLAIN_ITERS = 3
E2E_RUNS = 5
# the kernels of sorted_packed and bucketed_sort_words
MAIN_PATH = ("oets_rows_lex", "bitonic_rows_lex", "distribute_rows",
             "merge_adjacent_lex")
NARROW_N = 230_000
# the CUDA functions behind each kernel's C entry point, as the profiler
# names them
DEVICE_NAMES = {
    "oets_rows_lex": ("oets_rows_kernel",),
    "bitonic_rows_lex": ("bitonic_rows_kernel",),
    "distribute_rows": ("distribute_count_kernel", "distribute_scan_kernel",
                        "distribute_offset_kernel"),
    "merge_adjacent_lex": ("merge_window_kernel", "merge_regs_kernel"),
    "merge_runs_lex": ("runmerge_kernel",),
    "merge_runs_kway": ("kway_kernel",),
    "partition_rows": ("partition_prep_kernel", "partition_kernel"),
}
MERGE_SWEEP_LANES = (1, 2, 3, 4, 5, 8, 9)
SPLITTER_SWEEP = (0, 1, 2, 31, 32, 33, 127, 128, 1000)   # and MAX_SPLITTERS
SPLITTER_SWEEP_COLS = (1, 3, 130, 16_385)


def cuda_time(fn, iters: int, warmup: int = 2) -> float:
    """Milliseconds per call of ``fn(i)`` from CUDA events around ``iters``
    calls after ``warmup`` calls."""
    import torch
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_time(kernel_name: str, fn, iters: int = KERNEL_ITERS):
    """Device milliseconds per call of ``fn(i)`` spent in the CUDA functions
    of ``kernel_name`` (:data:`DEVICE_NAMES`), where the number comes from,
    and its split by function: ``torch.profiler``'s CUDA time by kernel
    name over ``iters`` calls after a warm-up ('profiler'), or, where the
    profiler shows no device time, CUDA events around the replay of a CUDA
    graph of ``iters`` calls, which takes the host's launch cost out of the
    window ('graph events', no split)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    names = DEVICE_NAMES[kernel_name]
    fn(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(i)
        torch.cuda.synchronize()
    split = {}
    for ev in prof.key_averages():
        name = next((n for n in names if n in ev.key), None)
        if name is not None:
            t = getattr(ev, "device_time_total", None)
            t = t if t is not None else ev.cuda_time_total
            split[name] = split.get(name, 0.0) + t / iters / 1e3
    if sum(split.values()) > 0:
        return sum(split.values()), "profiler", split
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(i)
    return (cuda_time(lambda i: graph.replay(), 5, 1) / iters,
            "graph events", None)


def device_fields(kernel_name: str, fn) -> dict:
    """``device_ms`` and its source, and for a kernel of more than one CUDA
    function its split by function."""
    ms, source, split = device_time(kernel_name, fn)
    out = {"device_ms": ms, "device_ms_source": source}
    if split and len(DEVICE_NAMES[kernel_name]) > 1:
        out["device_ms_by_function"] = split
    return out


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip()


def shortlex(words):
    return sorted(words, key=lambda w: (len(w.encode()), w.encode()))


def lib_sort(x, keys):
    """The rows of stacked ``x`` ``(A, R, C)`` sorted by stacked int32
    ``keys`` (signed lex order) through a chain of stable ``torch.sort``
    passes from the last lane to the first — the library yardstick."""
    import torch
    perm = torch.arange(x.shape[-1], device=x.device).expand(
        x.shape[1], -1).contiguous()
    for a in reversed(range(keys.shape[0])):
        _, idx = torch.sort(keys[a].gather(-1, perm), dim=-1, stable=True)
        perm = perm.gather(-1, idx)
    return torch.stack([lane.gather(-1, perm) for lane in x])


def bits_err(a, b) -> int:
    """Largest difference between two int32 bit tensors read as uint32."""
    import torch
    if a.numel() == 0:
        return 0
    return int(((a.to(torch.int64) & 0xFFFFFFFF)
                - (b.to(torch.int64) & 0xFFFFFFFF)).abs().max())


class Report:
    """Per-kernel numbers for the final JSON line: one row for every kernel
    of the package."""

    def __init__(self):
        from repro_torch.kernels import KERNELS
        self.rows = {k.name: {
            "name": k.name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{k.source}",
            "replaces": k.replaces, "launches": 0, "max_abs_err": 0}
            for k in KERNELS.values()}

    def add(self, kernel, err: int, **numbers):
        row = self.rows[kernel.name]
        row["max_abs_err"] = max(row["max_abs_err"], err)
        row.update(numbers)


def bound(bytes_moved: float, ops: float) -> dict:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / NON_TENSOR_OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


# --- phase 1 ----------------------------------------------------------------

def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.build_all()
    print(f"[build] nvcc for sm_90a, {len(_build.SOURCES)} sources in "
          f"parallel: {time.perf_counter() - t0:.1f} s")
    for source, text in _build.ptxas_report().items():
        for line in text.splitlines():
            if any(k in line for k in ("Compiling entry", "registers",
                                       "spill", "error", "warning")):
                print(f"[build] {source}: {line.strip()}")


# --- phase 2 ----------------------------------------------------------------

def stacked_buckets(keys_np, device, width=None):
    """The main path's sort input for packed words: the bucket tensor masked
    past each count and stacked lane-major ``(lanes, buckets, width)``,
    ``width`` a function of the capacity (default: the capacity)."""
    import torch
    from repro_torch import to_device
    from repro_torch.kernels import lex, ops
    keys = to_device(keys_np, device)
    buckets, counts, _ = ops.bucketize(keys)
    bits = lex.as_bits(buckets)
    cap = int(counts.max())
    bits = bits[:, :cap]
    slot = torch.arange(cap, device=device)
    bits = torch.where((slot[None, :] >= counts[:, None])[..., None], -1, bits)
    n_lanes = bits.shape[2]
    return ops._pad_stack([bits[..., l] for l in range(n_lanes)],
                          [lex.U32] * n_lanes, width(cap) if width else cap)


def adversarial(kind, shape, rng, device):
    """``(x, codes)``: a stacked input of ``shape`` = (lanes, rows, cols)."""
    import numpy as np
    import torch
    from repro_torch.kernels import lex
    a, r, c = shape
    if kind == "sentinel":
        v = rng.integers(0, 1 << 32, (a, r, c), dtype=np.uint64)
        v[rng.random((a, r, c)) < 0.3] = 0xFFFFFFFF
        codes = [lex.U32] * a
    elif kind == "dup_heavy":
        v = rng.integers(0, 4, (a, r, c), dtype=np.uint64)
        codes = [lex.U32] * a
    else:  # float32 key lanes with NaN/±0/±inf, an int32 lane, a payload
        f = rng.normal(scale=10.0, size=(a - 1, r, c)).astype(np.float32)
        pick = rng.random(f.shape)
        f[pick < 0.15] = np.inf
        f[(pick >= 0.15) & (pick < 0.25)] = -np.inf
        f[(pick >= 0.25) & (pick < 0.35)] = 0.0
        f[(pick >= 0.35) & (pick < 0.45)] = -0.0
        pats = np.array([0x7FC00000, 0x7FC00001, 0xFFC00000, 0x7F800001,
                         0xFFFFFFFF], np.uint32).view(np.float32)
        nan = pick >= 0.85
        f[nan] = pats[rng.integers(0, len(pats), int(nan.sum()))]
        v = f.view(np.uint32).astype(np.uint64)
        v[-1] = rng.integers(-3, 3, (r, c)).astype(np.int32).view(np.uint32)
        payload = np.stack([rng.permutation(c) for _ in range(r)])[None]
        v = np.concatenate([v, payload.astype(np.uint64)])
        codes = [lex.F32] * (a - 2) + [lex.I32, lex.I32]
    x = torch.from_numpy(v.astype(np.uint32).view(np.int32)).to(device)
    return x.contiguous(), codes


def check_sorted(kernel_name, x_in, out, codes):
    """``out`` must hold the rows of ``x_in`` in total order: its order keys
    equal those of the library sort, and each row's tuples are a bit-level
    permutation of the input row's."""
    import torch
    from repro_torch.kernels import lex
    ref = lib_sort(x_in, lex.order_keys(x_in, codes))
    if not torch.equal(lex.order_keys(out, codes), lex.order_keys(ref, codes)):
        raise AssertionError(f"{kernel_name}: output not in total order")
    if not torch.equal(lib_sort(out, out), lib_sort(x_in, x_in)):
        raise AssertionError(f"{kernel_name}: output is not a permutation "
                             "of the input")


def check_row_kernel(kernel, wrapper, plain, x, codes, label, **kw):
    """Kernel vs plain version (bits) and vs the library sort (order);
    returns the bit error. ``kw`` goes to the wrapper (the merge block)."""
    import torch
    got = wrapper(x.clone(), codes, **kw)
    want = plain(x.clone(), codes, **kw)
    torch.cuda.synchronize()
    err = bits_err(got, want)
    print(f"[kernels] {kernel.name} {label} {tuple(x.shape)}: "
          f"max_abs_err {err}")
    if err:
        raise AssertionError(f"{kernel.name} {label}: kernel and plain "
                             "version differ")
    return err, got


def time_row_kernel(kernel, wrapper, plain, lib, x, codes, **kw):
    """Kernel over distinct fresh copies (in place), its device time over
    the same calls, plain version, library."""
    copies = [x.clone() for _ in range(min(KERNEL_ITERS, 8))]

    def call(i):
        return wrapper(copies[i % len(copies)].copy_(x), codes, **kw)

    ms = cuda_time(call, KERNEL_ITERS)
    copy_ms = cuda_time(lambda i: copies[i % len(copies)].copy_(x),
                        KERNEL_ITERS)
    device = device_fields(kernel.name, call)
    plain_ms = cuda_time(lambda i: plain(x, codes, **kw), PLAIN_ITERS, 1)
    library_ms = cuda_time(lambda i: lib(x), KERNEL_ITERS)
    return {"ms": ms - copy_ms, **device, "plain_ms": plain_ms,
            "library_ms": library_ms}


def merge_sweep(device) -> int:
    """B4 against its plain version at every power-of-two block from 1 to
    the shared-memory cap, at offsets 0 and ``block``, for every lane count
    of :data:`MERGE_SWEEP_LANES` and each code and fill: the in-thread,
    shuffle and shared-memory stages of its network, and the register-only
    kernel. Returns the largest bit error."""
    import numpy as np
    import torch
    from repro_torch.kernels import adversarial, lex, merge_kernel
    rng = np.random.default_rng(4)
    worst = 0
    for n in MERGE_SWEEP_LANES:
        cap = merge_kernel.max_merge_block(n)
        for code_name, code in (("u32", lex.U32), ("i32", lex.I32),
                                ("f32", lex.F32)):
            codes = [code] * n
            for fill in adversarial.FILLS:
                err, block = 0, 1
                while block <= cap:
                    x = torch.from_numpy(adversarial.lane_bits(
                        rng, (n, 3, 7 * block), code, fill)).to(device)
                    xb = x.view(n, -1, block)
                    x = lib_sort(xb, lex.order_keys(xb, codes)).reshape(
                        n, 3, -1).contiguous()
                    for lo in (0, block):
                        got = merge_kernel.merge_adjacent_lex(
                            x.clone(), codes, block=block, lo=lo)
                        want = x.clone()
                        want[..., lo:lo + 6 * block] = \
                            merge_kernel.merge_network_plain(
                                x[..., lo:lo + 6 * block], codes, block)
                        torch.cuda.synchronize()
                        err = max(err, bits_err(got, want))
                    block *= 2
                print(f"[kernels] merge_adjacent_lex sweep {n} lanes "
                      f"{code_name} {fill}, blocks 1..{cap}, lo 0 and "
                      f"block: max_abs_err {err}")
                if err:
                    raise AssertionError(f"merge_adjacent_lex sweep {n} "
                                         f"{code_name} {fill}: kernel and "
                                         "plain version differ")
                worst = max(worst, err)
    return worst


def phase_kernels(report, device, ds2_keys, chunk500_keys, chunk3000_keys):
    import numpy as np
    import torch
    from repro_torch.core.blocksort import default_block_size
    from repro_torch.kernels import (bitonic_kernel, distribute_kernel, lex,
                                     merge_kernel, oets_kernel, ops)
    rng = np.random.default_rng(0)
    U4 = [lex.U32] * 4

    def plain_oets(x, codes):
        return oets_kernel.oets_rows_lex_plain(x, codes)

    def plain_bitonic(x, codes):
        return bitonic_kernel.bitonic_rows_lex_plain(x, codes)

    def plain_merge(x, codes, block):
        return merge_kernel.merge_network_plain(x, codes, block)

    def merge(x, codes, block):
        return merge_kernel.merge_adjacent_lex(x, codes, block=block)

    # B1 at the OETS tier's shape: the 500-word chunk's buckets, width 128
    x = stacked_buckets(chunk500_keys, device, lambda cap: 128)
    k = oets_kernel.KERNEL
    err, got = check_row_kernel(k, oets_kernel.oets_rows_lex, plain_oets, x,
                                U4, "chunk-500 buckets")
    check_sorted(k.name, x, got, U4)
    for kind in ("sentinel", "dup_heavy", "float"):
        xa, ca = adversarial(kind, (5 if kind == "float" else 4,) + x.shape[1:],
                             rng, device)
        e, got = check_row_kernel(k, oets_kernel.oets_rows_lex, plain_oets,
                                  xa, ca, kind)
        check_sorted(k.name, xa, got, ca)
        err = max(err, e)
    a, r, c = x.shape
    report.add(k, err, shape=list(x.shape),
               **time_row_kernel(k, oets_kernel.oets_rows_lex, plain_oets,
                                 lambda t: lib_sort(t, t ^ (-1 << 31)), x, U4),
               **bound(2 * a * r * c * 4, r * c * (c - 1) // 2 * a))

    # B2 as the bitonic tier (3,000-word chunk) and as blocksort's local
    # sort at DS2 (the timed shape)
    k = bitonic_kernel.KERNEL
    x = stacked_buckets(chunk3000_keys, device, ops._next_pow2)
    err, got = check_row_kernel(k, bitonic_kernel.bitonic_rows_lex,
                                plain_bitonic, x, U4, "chunk-3000 buckets")
    check_sorted(k.name, x, got, U4)
    sizes = {}

    def blocks(cap):
        sizes["block"] = default_block_size(cap, n_arrays=4)
        sizes["nb"] = -(-cap // sizes["block"])
        return sizes["nb"] * sizes["block"]

    x = stacked_buckets(ds2_keys, device, blocks)
    block, nb = sizes["block"], sizes["nb"]
    xl = x.view(4, -1, block)
    e, got = check_row_kernel(k, bitonic_kernel.bitonic_rows_lex,
                              plain_bitonic, xl, U4, "DS2 local blocks")
    check_sorted(k.name, xl, got, U4)
    err = max(err, e)
    for kind in ("sentinel", "dup_heavy", "float"):
        xa, ca = adversarial(kind, (5 if kind == "float" else 4, 64, block),
                             rng, device)
        e, got = check_row_kernel(k, bitonic_kernel.bitonic_rows_lex,
                                  plain_bitonic, xa, ca, kind)
        check_sorted(k.name, xa, got, ca)
        err = max(err, e)
    a, r, c = xl.shape
    m = c.bit_length() - 1
    report.add(k, err, shape=list(xl.shape),
               **time_row_kernel(k, bitonic_kernel.bitonic_rows_lex,
                                 plain_bitonic,
                                 lambda t: lib_sort(t, t ^ (-1 << 31)), xl,
                                 U4),
               **bound(2 * a * r * c * 4, r * (c // 2) * m * (m + 1) // 2 * a))

    # B4 at DS2: the first (even) merge round over the locally sorted blocks
    k = merge_kernel.KERNEL
    xs = bitonic_kernel.bitonic_rows_lex(xl.clone(), U4).view(4, x.shape[1], -1)
    npairs = nb // 2
    xm = xs[:, :, :npairs * 2 * block].contiguous()
    err, got = check_row_kernel(k, merge, plain_merge, xm, U4,
                                f"DS2 round, block {block}", block=block)
    check_sorted(k.name, xm.view(4, -1, 2 * block),
                 got.view(4, -1, 2 * block), U4)
    for kind in ("sentinel", "dup_heavy", "float"):
        xa, ca = adversarial(kind, (5 if kind == "float" else 4, 32, block),
                             rng, device)
        xa = bitonic_kernel.bitonic_rows_lex(xa, ca).view(xa.shape[0], 16, -1)
        e, got = check_row_kernel(k, merge, plain_merge, xa, ca, kind,
                                  block=block)
        check_sorted(k.name, xa, got, ca)
        err = max(err, e)
    err = max(err, merge_sweep(device))
    a, r, c = xm.shape
    report.add(k, err, shape=list(xm.shape), block=block,
               **time_row_kernel(
                   k, merge, plain_merge,
                   lambda t: lib_sort(t.view(a, -1, 2 * block),
                                      t.view(a, -1, 2 * block) ^ (-1 << 31)),
                   xm, U4, block=block),
               **bound(2 * a * r * c * 4,
                       r * (c // 2) * (block.bit_length()) * a))

    # B3 at DS2: the packed words, plus words with interior NUL bytes and
    # 0xFF bytes and a padded tail
    k = distribute_kernel.KERNEL
    from repro_torch import to_device
    keys = lex.as_bits(to_device(ds2_keys, device)).contiguous()
    raw = rng.integers(0, 1 << 32, (100_003, 4), dtype=np.uint64)
    byte_mask = rng.random((100_003, 4, 4)) < 0.5
    for j in range(4):
        raw &= ~(byte_mask[..., j].astype(np.uint64) << (24 - 8 * j))
    adv = torch.from_numpy(raw.astype(np.uint32).view(np.int32)).to(device)
    err = 0
    for label, kk, n_valid in (("DS2 words", keys, keys.shape[0]),
                               ("NUL/0xFF bytes, padded tail", adv,
                                adv.shape[0] - 777)):
        got = distribute_kernel.distribute_rows(kk, n_valid)
        want = distribute_kernel.distribute_rows_plain(kk, n_valid)
        torch.cuda.synchronize()
        e = max(bits_err(g, w) for g, w in zip(got, want))
        hist = torch.bincount(got[0][:n_valid].long(), minlength=17)[:17]
        print(f"[kernels] {k.name} {label} {tuple(kk.shape)}: "
              f"max_abs_err {e}")
        if e or not torch.equal(hist.to(torch.int32), got[2]):
            raise AssertionError(f"{k.name} {label}: kernel and plain "
                                 "version differ")
        err = max(err, e)
    n = keys.shape[0]
    report.add(k, err, shape=list(keys.shape),
               ms=cuda_time(lambda i: distribute_kernel.distribute_rows(keys),
                            KERNEL_ITERS),
               **device_fields(k.name,
                               lambda i: distribute_kernel.distribute_rows(keys)),
               plain_ms=cuda_time(
                   lambda i: distribute_kernel.distribute_rows_plain(keys, n),
                   PLAIN_ITERS, 1),
               library_ms=None,
               **bound(n * 4 * 4 + 2 * n * 4 + 17 * 4, n * 4))
    for name in MAIN_PATH:
        row = report.rows[name]
        print(f"[kernels] {name}: " + ", ".join(
            f"{key} {row.get(key)}" for key in (
                "shape", "ms", "device_ms", "device_ms_by_function",
                "plain_ms", "library_ms", "bound_ms", "bound_by")))


def ext_runs(keys, device, chunk=4096):
    """Packed words chunked at ``chunk`` and sorted on the card: the runs
    the run tier merges, as extended tuples (compare lanes, then data
    lanes), and the compare-lane count."""
    from repro_torch.pipeline import sorted_run
    runs = [sorted_run(keys[s:s + chunk], capacity=chunk, device=device)
            for s in range(0, len(keys), chunk)]
    ext = [tuple(r.cmp_lanes()) + tuple(r.lanes()) for r in runs]
    return ext, len(ext[0]) - len(runs[0].lanes())


def sorted_lanes_runs(kind, sizes, rng, device):
    """Sorted runs of an adversarial ``kind`` on the card and the
    compare-lane count to merge them with (None: pack them)."""
    import numpy as np
    import torch
    from repro_torch import to_device
    from repro_torch.core import packing
    from repro_torch.pipeline import sorted_run
    from repro_torch.pipeline.validate import order_bits_view
    if kind == "words-32-bytes":
        runs = []
        for n in sizes:
            words = ["".join(rng.choice(list("abcz"), int(ln)))
                     for ln in rng.integers(1, 33, n)]
            r = sorted_run(packing.pack_words(words, width=32), device=device)
            runs.append(tuple(r.cmp_lanes()) + tuple(r.lanes()))
        return runs, len(runs[0]) - 9
    runs = []
    for n in sizes:
        if kind == "float":
            f = rng.normal(scale=10.0, size=n).astype(np.float32)
            pick = rng.random(n)
            f[pick < 0.15] = np.nan
            f[(pick >= 0.15) & (pick < 0.3)] = -0.0
            f[(pick >= 0.3) & (pick < 0.45)] = 0.0
            f[(pick >= 0.45) & (pick < 0.5)] = -np.inf
            pats = np.array([0x7FC00001, 0xFFC00000, 0x7F800001, 0xFFFFFFFF],
                            np.uint32).view(np.float32)
            m = pick >= 0.9
            f[m] = pats[rng.integers(0, len(pats), int(m.sum()))]
            p = rng.integers(-3, 3, n).astype(np.int32)
            order = np.lexsort((p, order_bits_view(f)))
            runs.append((to_device(f[order], device),
                         to_device(p[order], device)))
            continue
        v = rng.integers(0, 4 if kind == "dup_heavy" else 1 << 32, (3, n),
                         dtype=np.uint64).astype(np.uint32)
        if kind == "sentinel":
            v[rng.random((3, n)) < 0.3] = 0xFFFFFFFF
        order = np.lexsort(v[::-1])
        runs.append(tuple(to_device(np.ascontiguousarray(l[order]), device)
                          for l in v))
    return runs, (3 if kind == "dup_heavy" else None)


def check_merge_contract(name, got, runs):
    """``got`` (stacked int32, the merged lanes) holds the runs' tuples bit
    for bit and is sorted under the total order."""
    import numpy as np
    import torch
    from repro_torch import to_numpy
    from repro_torch.kernels import lex
    from repro_torch.pipeline.validate import check_lanes_sorted
    flat = torch.stack([torch.cat([lex.as_bits(r[l]) for r in runs])
                        for l in range(len(runs[0]))])
    if not torch.equal(lib_sort(flat[:, None], flat[:, None]),
                       lib_sort(got[:, None], got[:, None])):
        raise AssertionError(f"{name}: output is not a permutation of the "
                             "input")
    typed = [to_numpy(lex.from_bits(got[l].contiguous(), runs[0][l].dtype))
             for l in range(len(runs[0]))]
    check_lanes_sorted([np.asarray(t) for t in typed], what=name)


def check_merge_kernel(kernel, label, fn, plain, args, block, runs=None):
    """Kernel vs plain version on the same operands (bits); with ``runs``,
    also the total-order contract. Returns the bit error and the output."""
    import torch
    got = fn(*args, block)
    want = plain(*args, block)
    torch.cuda.synchronize()
    err = bits_err(got, want)
    print(f"[kernels] {kernel.name} {label}: max_abs_err {err}")
    if err:
        raise AssertionError(f"{kernel.name} {label}: kernel and plain "
                             "version differ")
    if runs is not None:
        check_merge_contract(f"{kernel.name} {label}", got, runs)
    return err, got


def phase_run_merges(report, device, ds2_keys):
    """B5 and B6 at the run tier's own shapes, on adversarial runs, and
    timed beside their plain versions and the torch tiers."""
    import math
    import numpy as np
    import torch
    from repro_torch.kernels import keypack, kway_kernel as kk, lex, \
        runmerge_kernel as rk
    rng = np.random.default_rng(1)
    ext, n_cmp = ext_runs(ds2_keys, device)
    n_arr, k = len(ext[0]), len(ext)

    # B6 at DS2's 57 runs of <= 4096
    ops = kk.kway_operands(ext, n_cmp, block=kk.DEFAULT_KWAY_BLOCK)
    blk = kk.DEFAULT_KWAY_BLOCK
    err, got = check_merge_kernel(kk.KERNEL, f"DS2 {k} runs, {n_arr} arrays",
                                  kk.kway_merge, kk.kway_merge_plain, ops, blk)
    take = kk.merge_runs_kway_take(ext, n_cmp=n_cmp)
    if bits_err(got, torch.stack([lex.as_bits(t) for t in take])):
        raise AssertionError("merge_runs_kway: kernel and torch tier differ")
    for kind, sizes in (("sentinel", (5000, 3000, 1, 2500)),
                        ("dup_heavy", (4096,) * 9),
                        ("empty and single", (0, 1, 0, 4096, 1, 700, 0)),
                        ("words-32-bytes", (3000, 2000, 500)),
                        ("float", (3000, 1, 2000))):
        gen = "dup_heavy" if kind == "empty and single" else kind
        runs, nc = sorted_lanes_runs(gen, sizes, rng, device)
        runs = [r for r in runs if r[0].shape[0]]
        e, _ = check_merge_kernel(kk.KERNEL, f"{kind} {sizes}", kk.kway_merge,
                                  kk.kway_merge_plain,
                                  kk.kway_operands(runs, nc), blk, runs)
        err = max(err, e)
    total = got.shape[1]
    ms_engine = cuda_time(lambda i: kk.merge_runs_kway_kernel(
        ext, n_cmp=n_cmp), 3, 1)
    report.add(kk.KERNEL, err, shape=[n_arr, total], runs=k, block=blk,
               ms=cuda_time(lambda i: kk.kway_merge(*ops, blk), KERNEL_ITERS),
               **device_fields(kk.KERNEL.name,
                               lambda i: kk.kway_merge(*ops, blk)),
               plain_ms=cuda_time(lambda i: kk.kway_merge_plain(*ops, blk),
                                  PLAIN_ITERS, 1),
               torch_tier_ms=cuda_time(lambda i: kk.merge_runs_kway_take(
                   ext, n_cmp=n_cmp), KERNEL_ITERS),
               engine_ms=ms_engine, library_ms=None,
               **bound(2 * n_arr * total * 4 + ops[2].numel() * 4,
                       total * math.ceil(math.log2(k)) * n_cmp))

    # B5 at the last tournament round of the same runs: the merge of runs
    # [0, 32) against runs [32, 57), each side merged first
    half = 1 << ((k - 1).bit_length() - 1)
    a = kk.merge_runs_kway_take(ext[:half], n_cmp=n_cmp)
    b = kk.merge_runs_kway_take(ext[half:], n_cmp=n_cmp)
    blk = rk.DEFAULT_MERGE_BLOCK
    ops = rk.merge_operands(a, b, n_cmp, block=blk)
    err, got = check_merge_kernel(
        rk.KERNEL, f"DS2 last round {a[0].shape[0]} + {b[0].shape[0]}, "
        f"{n_arr} arrays", rk.runmerge, rk.runmerge_plain, ops, blk)
    if bits_err(got, torch.stack([lex.as_bits(t) for t in take])):
        raise AssertionError("merge_runs_lex: kernel and the k-way merge "
                             "differ")
    for kind, sizes in (("sentinel", (5000, 3000)),
                        ("dup_heavy", (4096, 4000)),
                        ("empty and single", (1, 5000)),
                        ("single", (700, 1)),
                        ("words-32-bytes", (3000, 2000)),
                        ("float", (3000, 2000))):
        gen = "dup_heavy" if kind in ("empty and single", "single") else kind
        runs, nc = sorted_lanes_runs(gen, sizes, rng, device)
        e, _ = check_merge_kernel(rk.KERNEL, f"{kind} {sizes}", rk.runmerge,
                                  rk.runmerge_plain,
                                  rk.merge_operands(*runs, nc), blk, runs)
        err = max(err, e)
        empty = tuple(x[:0] for x in runs[0])
        out = rk.merge_runs_lex_kernel(empty, runs[1], nc)
        if not all(x is y for x, y in zip(out, runs[1])):
            raise AssertionError("merge_runs_lex: an empty run changed the "
                                 "other")
    total = got.shape[1]
    report.add(rk.KERNEL, err, shape=[n_arr, total], block=blk,
               ms=cuda_time(lambda i: rk.runmerge(*ops, blk), KERNEL_ITERS),
               **device_fields(rk.KERNEL.name,
                               lambda i: rk.runmerge(*ops, blk)),
               plain_ms=cuda_time(lambda i: rk.runmerge_plain(*ops, blk),
                                  PLAIN_ITERS, 1),
               torch_tier_ms=cuda_time(lambda i: keypack.merge_take_packed(
                   a, b, n_cmp=n_cmp), KERNEL_ITERS),
               engine_ms=cuda_time(lambda i: rk.merge_runs_lex_kernel(
                   a, b, n_cmp=n_cmp), 3, 1),
               library_ms=None,
               **bound(2 * n_arr * total * 4 + ops[4].numel() * 4,
                       total * n_cmp))
    for name in (rk.KERNEL.name, kk.KERNEL.name):
        row = report.rows[name]
        print(f"[kernels] {name}: " + ", ".join(
            f"{key} {row.get(key)}" for key in ("shape", "ms", "device_ms",
                                            "plain_ms", "torch_tier_ms",
                                            "engine_ms", "bound_ms",
                                            "bound_by")))


# --- phase 3 ----------------------------------------------------------------

def phase_main_path(report, device, datasets):
    """Each dataset through the main path once, checked, with the launch
    counters set to 0 just before and read just after; then timed."""
    import numpy as np
    import torch
    from repro_torch import bucketed_sort_words, sorted_packed, to_numpy
    from repro_torch.core import packing
    from repro_torch.kernels import KERNELS
    total = dict.fromkeys(KERNELS, 0)
    for name, words in datasets:
        oracle = shortlex(words)
        keys = packing.pack_words(words)
        capacity = max(Counter(len(w.encode()) for w in words).values())
        for k in KERNELS.values():
            k.launches = 0
        torch.cuda.reset_peak_memory_stats()
        out = bucketed_sort_words(words, device=device)
        lens, sk, packed = sorted_packed(keys, return_packed=True,
                                         device=device)
        torch.cuda.synchronize()
        runs = {n: k.launches for n, k in KERNELS.items()}
        peak = torch.cuda.max_memory_allocated()
        for n, c in runs.items():
            total[n] += c
        if out != oracle:
            raise AssertionError(f"{name}: bucketed_sort_words is not the "
                                 "shortlex order")
        want = packing.pack_words(oracle, width=keys.shape[1] * 4)
        if not (np.array_equal(to_numpy(sk), want) and np.array_equal(
                to_numpy(lens), [len(w.encode()) for w in oracle])):
            raise AssertionError(f"{name}: sorted_packed differs from the "
                                 "shortlex oracle")
        if name == "DS1":
            cpu = sorted_packed(keys, return_packed=True, device="cpu")
            for g, w in zip((lens, sk) + packed, cpu[:2] + cpu[2]):
                if not np.array_equal(to_numpy(g), to_numpy(w)):
                    raise AssertionError("DS1: the card's packed lanes "
                                         "differ from the plain CPU path")
        e2e, dev = [], []
        for _ in range(E2E_RUNS):
            t0 = time.perf_counter()
            bucketed_sort_words(words, device=device)
            e2e.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            sorted_packed(keys, return_packed=True, device=device)
            torch.cuda.synchronize()
            dev.append(time.perf_counter() - t0)
        t_e2e, t_dev = statistics.median(e2e), statistics.median(dev)
        print(f"[main] {name}: {len(words)} words, capacity {capacity}, "
              f"launches of one bucketed_sort_words + one sorted_packed "
              f"{runs}; bucketed_sort_words median {t_e2e * 1e3:.3f} ms "
              f"({len(words) / t_e2e:.0f} words/s), sorted_packed median "
              f"{t_dev * 1e3:.3f} ms ({len(words) / t_dev:.0f} words/s), "
              f"max_memory_allocated {peak} B, shortlex oracle: equal")
    for name, count in total.items():
        report.rows[name]["launches"] = count
        if count == 0 and name in MAIN_PATH:
            raise AssertionError(f"{name} was never launched on the main "
                                 "path")


def launch_counts(run):
    """``run()`` with every launch counter set to 0 just before and read
    just after; returns ``(result, {kernel: launches})``."""
    import torch
    from repro_torch.kernels import KERNELS
    for k in KERNELS.values():
        k.launches = 0
    out = run()
    torch.cuda.synchronize()
    return out, {n: k.launches for n, k in KERNELS.items()}


def phase_run_tier(report, device, ds2_words, big_words):
    """The run tier end to end: the chunked sorts through their entry
    points, each checked against the shortlex oracle with the launch
    counters read around it, then timed: the whole call (median), and the
    same work in its two stages, the chunk sorts and the combine."""
    import numpy as np
    import torch
    from repro_torch import to_numpy
    from repro_torch.core import packing
    from repro_torch.kernels import KERNELS
    from repro_torch.pipeline import (chunked_sort_packed, chunked_sort_words,
                                      merge_runs, sorted_run)
    ds2_oracle = shortlex(ds2_words)
    big_keys = packing.pack_words(big_words)
    big_oracle = packing.pack_words(shortlex(big_words), width=16)
    cases = (
        ("DS2 chunked, k-way", ds2_words, 4096, "auto", "merge_runs_kway",
         lambda: chunked_sort_words(ds2_words, chunk_size=4096,
                                    merge_engine="auto", device=device)),
        ("DS2 chunked, tournament", ds2_words, 4096, "tournament",
         "merge_runs_lex",
         lambda: chunked_sort_words(ds2_words, chunk_size=4096,
                                    merge_engine="tournament",
                                    device=device)),
        ("1M words chunked, k-way, validate=full", big_words, 16384, "auto",
         "merge_runs_kway",
         lambda: chunked_sort_packed(big_keys, chunk_size=16384,
                                     validate="full", device=device)),
    )
    for name, words, chunk, engine, merge_kernel, run in cases:
        torch.cuda.reset_peak_memory_stats()
        out, counts = launch_counts(run)
        peak = torch.cuda.max_memory_allocated()
        if isinstance(out, list):
            ok = out == ds2_oracle
        else:
            ok = np.array_equal(to_numpy(out.keys), big_oracle)
        if not ok:
            raise AssertionError(f"{name}: not the shortlex order")
        for kname in ("distribute_rows", "bitonic_rows_lex",
                      "merge_adjacent_lex", merge_kernel):
            if counts[kname] == 0:
                raise AssertionError(f"{name}: {kname} never launched")
        for kname, c in counts.items():
            report.rows[kname]["launches"] += c
        reps = 3 if len(words) < 500_000 else 1
        total = []
        for _ in range(reps):
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            total.append(time.perf_counter() - t0)
        keys = packing.pack_words(words)
        t0 = time.perf_counter()
        runs = [sorted_run(keys[s:s + chunk], capacity=chunk, device=device)
                for s in range(0, len(keys), chunk)]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        merge_runs([r.lanes() for r in runs], engine=engine,
                   cmp_runs=[r.cmp_lanes() for r in runs])
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        t = statistics.median(total)
        print(f"[run tier] {name}: {len(words)} words, {len(runs)} runs, "
              f"launches {counts}; total median {t * 1e3:.3f} ms "
              f"({len(words) / t:.0f} words/s) over {reps}; staged: chunk "
              f"sorts {(t1 - t0) * 1e3:.3f} ms, combine "
              f"{(t2 - t1) * 1e3:.3f} ms; max_memory_allocated {peak} B; "
              "shortlex oracle: equal")


# --- phase 4 ----------------------------------------------------------------

def quantiles(x, n_spl: int):
    """``n_spl`` int32 splitters at the (j + 1) / (n_spl + 1) quantiles of
    ``x``'s values, as a sample sort draws them."""
    import torch
    s = torch.sort(x.reshape(-1)).values
    idx = (torch.arange(1, n_spl + 1, device=x.device) * s.numel()
           // (n_spl + 1))
    return s[idx].contiguous()


def partition_adversarial(device):
    """``(label, keys, splitters)`` adversarial inputs of B7, int32."""
    import numpy as np
    import torch
    rng = np.random.default_rng(2)
    info = np.iinfo(np.int32)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)

    ext = rng.integers(-5, 5, (4, 3000)).astype(np.int32)
    ext[:, ::3], ext[:, 1::3] = info.max, info.min
    eq = rng.choice(np.array([-7, 0, 9, 100], np.int32), (3, 5000))
    small = rng.integers(-1000, 1000, (16, 4096)).astype(np.int32)
    wrap = rng.integers(0, 1 << 32, (2, 5000), dtype=np.uint64).astype(
        np.uint32).view(np.int32)
    return [
        ("int32 extremes", t(ext), t([info.min, -1, 0, 4, info.max])),
        ("keys equal to splitters", t(eq), t([-7, 0, 9, 100])),
        ("duplicated splitters", t(small), t([-5, -5, -5, 0, 0, 700, 700])),
        ("unsorted splitters", t(small), t(rng.permutation(
            np.arange(-990, 1000, 30)))),
        ("no splitters", t(small), t(np.zeros(0))),
        ("C = 130, R = 1", t(small[:1, :130]), t([-500, 0, 500])),
        ("uint32 keys past 2^31", t(wrap), t(np.sort(rng.integers(
            info.min, info.max, 31)))),
    ]


def partition_sweep(device) -> int:
    """B7 against its plain version for every splitter count of
    :data:`SPLITTER_SWEEP` and ``MAX_SPLITTERS``, unsorted with duplicates
    (and both int32 extremes), on three rows of keys of which a third equal
    a splitter and a tenth sit at INT32_MIN or INT32_MAX, at ragged column
    counts that leave a vector tail; the ids must also be the upper bounds
    over the sorted splitters. Returns the largest error."""
    import torch
    from repro_torch.kernels import adversarial, partition_kernel as pk
    worst = 0
    for n_spl in SPLITTER_SWEEP + (pk.MAX_SPLITTERS,):
        for cols in SPLITTER_SWEEP_COLS:
            x, s = (torch.from_numpy(a).to(device) for a in
                    adversarial.partition_case(n_spl, cols, seed=5))
            bid, cnt = pk.partition_rows(x, s)
            want = pk.partition_rows_plain(x, s)
            torch.cuda.synchronize()
            e = max(bits_err(bid, want[0]), bits_err(cnt, want[1]))
            ref = torch.searchsorted(torch.sort(s).values, x, right=True)
            print(f"[partition] {pk.KERNEL.name} sweep {n_spl} splitters, "
                  f"(3, {cols}): max_abs_err {e}")
            if e or not torch.equal(bid.long(), ref):
                raise AssertionError(f"partition_rows sweep {n_spl} "
                                     f"splitters, {cols} columns: kernel, "
                                     "plain version and the upper bound "
                                     "differ")
            worst = max(worst, e)
    return worst


def phase_partition_and_repairs(report, device, ds2_words, big_words):
    """B7 behind ``partition_rows`` and the narrow-lane and packed sorts, on
    the card with the counters read around them; then B7 checked against
    its plain version and timed."""
    import numpy as np
    import torch
    from repro_torch import to_device
    from repro_torch.core import packing
    from repro_torch.kernels import lex, ops, partition_kernel as pk
    t0 = time.perf_counter()
    rng = np.random.default_rng(3)
    ds2_keys = packing.pack_words(ds2_words)
    ds2_lane = to_device(ds2_keys[:, 0].view(np.int32).reshape(8, -1), device)
    big_lane = to_device(packing.pack_words(big_words)[:, 0].view(np.int32)
                         .reshape(64, -1), device)
    lens = to_device(np.array([[len(w.encode()) for w in ds2_words]],
                              np.int32), device)
    cases = [("DS2 lane 0 (8, 28750), 7 splitters", ds2_lane,
              quantiles(ds2_lane, 7)),
             ("DS2 lane 0 (8, 28750), 127 splitters", ds2_lane,
              quantiles(ds2_lane, 127)),
             ("1M lane 0 (64, 16384), 127 splitters", big_lane,
              quantiles(big_lane, 127)),
             ("DS2 byte lengths (1, 230000), splitters 1..16", lens,
              torch.arange(1, 17, dtype=torch.int32, device=device))]
    narrow = {}
    for dt in (torch.int8, torch.int16, torch.uint8, torch.uint16):
        info = torch.iinfo(dt)
        v = rng.integers(info.min, info.max, NARROW_N, endpoint=True)
        v[:2] = (info.max, info.min)
        narrow[dt] = lex.from_bits(torch.from_numpy(v.astype(np.int32)), dt)
    bounded = [torch.from_numpy(rng.integers(0, 1024, NARROW_N).astype(
        np.int32)) for _ in range(2)]
    f = rng.normal(scale=10.0, size=NARROW_N).astype(np.float32)
    pick = rng.random(NARROW_N)
    f[pick < 0.15] = np.nan
    f[(pick >= 0.15) & (pick < 0.25)] = -0.0
    f[(pick >= 0.25) & (pick < 0.35)] = 0.0
    pats = np.array([0x7FC00001, 0xFFC00000, 0x7F800001, 0xFFFFFFFF],
                    np.uint32).view(np.float32)
    nan = pick >= 0.9
    f[nan] = pats[rng.integers(0, len(pats), int(nan.sum()))]
    floats = [torch.from_numpy(f), torch.from_numpy(
        rng.integers(-3, 3, NARROW_N).astype(np.int32))]

    def on_card(t):
        return lex.from_bits(lex.as_bits(t).to(device), t.dtype)

    def path():
        return ([ops.partition_rows(x, s) for _, x, s in cases],
                {dt: ops.sort(on_card(x)) for dt, x in narrow.items()},
                ops.sort_lex([on_card(t) for t in bounded],
                             max_values=(1023, 1023)),
                ops.sort_lex([on_card(t) for t in floats], engine="packed"))

    if ops.choose_lex_engine([torch.int32] * 2, (1023, 1023)) != "packed":
        raise AssertionError("sort_lex: bounded int32 lanes do not resolve "
                             "to the packed engine")
    (parts, sorted_narrow, packed_int, packed_float), counts = \
        launch_counts(path)
    for kname in ("partition_rows", "bitonic_rows_lex", "merge_adjacent_lex"):
        if counts[kname] == 0:
            raise AssertionError(f"partition and repaired sorts: {kname} "
                                 "never launched")
    for kname, c in counts.items():
        report.rows[kname]["launches"] += c
    print(f"[partition] launches of the path: {counts}")

    # the repaired sorts against the CPU port and torch.sort
    for dt, got in sorted_narrow.items():
        want = ops.sort(narrow[dt])
        lib = torch.sort(lex.as_bits(narrow[dt])).values
        if not (got.dtype == dt and torch.equal(lex.as_bits(got).cpu(),
                                                lex.as_bits(want))
                and torch.equal(lex.as_bits(want), lib)):
            raise AssertionError(f"sort of {NARROW_N} {dt} keys: the card, "
                                 "the CPU port and torch.sort differ")
        print(f"[partition] sort of {NARROW_N} {dt} keys: equal to the CPU "
              "port and to torch.sort")
    lanes_out = ops.sort_lex([on_card(t) for t in bounded], engine="lanes")
    cpu_out = ops.sort_lex(bounded, max_values=(1023, 1023))
    for g, w, c in zip(packed_int, lanes_out, cpu_out):
        if not (torch.equal(g, w) and torch.equal(g.cpu(), c)):
            raise AssertionError("sort_lex packed: differs from the lanes "
                                 "engine or the CPU port")
    cpu_out = ops.sort_lex(floats, engine="packed")
    for g, w in zip(packed_float, cpu_out):
        if not torch.equal(lex.as_bits(g).cpu(), lex.as_bits(w)):
            raise AssertionError("sort_lex packed float: differs from the "
                                 "CPU port")
    got = torch.stack([lex.as_bits(g) for g in packed_float])[:, None]
    inp = torch.stack([lex.as_bits(on_card(t)) for t in floats])[:, None]
    check_sorted("sort_lex packed float", inp, got, [lex.F32, lex.I32])
    print(f"[partition] sort_lex packed: bounded int32 lanes equal the lanes "
          f"engine and the CPU port; float32 NaN/±0 lane a bit-level "
          f"permutation in total order, equal to the CPU port")

    # B7 against its plain version
    err = 0
    hist = ops.distribute(to_device(ds2_keys, device))[2]
    for (label, x, s), (bid, cnt) in zip(cases, parts):
        want = pk.partition_rows_plain(x, s)
        e = max(bits_err(bid, want[0]), bits_err(cnt, want[1]))
        lib = torch.bucketize(x, s, right=True)
        if e or not torch.equal(bid.long(), lib) or not bool(
                (cnt.sum(dim=1) == x.shape[1]).all()):
            raise AssertionError(f"partition_rows {label}: kernel, plain "
                                 "version and torch.bucketize differ")
        err = max(err, e)
        print(f"[partition] {pk.KERNEL.name} {label}: max_abs_err {e}")
    if not torch.equal(parts[3][0], lens) or not torch.equal(parts[3][1][0],
                                                            hist):
        raise AssertionError("partition_rows of DS2's byte lengths: the ids "
                             "are not the lengths or the counts are not "
                             "B3's histogram")
    print("[partition] DS2 byte lengths: ids equal the lengths, counts "
          "equal B3's histogram")
    for label, x, s in partition_adversarial(device):
        if label.startswith("uint32"):
            bid, cnt = ops.partition_rows(x.view(torch.uint32), s)
        else:
            bid, cnt = pk.partition_rows(x, s)
        want = pk.partition_rows_plain(x, s)
        e = max(bits_err(bid, want[0]), bits_err(cnt, want[1]))
        print(f"[partition] {pk.KERNEL.name} {label} {tuple(x.shape)}, "
              f"{s.numel()} splitters: max_abs_err {e}")
        if e:
            raise AssertionError(f"partition_rows {label}: kernel and plain "
                                 "version differ")
        err = max(err, e)
    err = max(err, partition_sweep(device))

    # times at the million-word shape
    _, x, s = cases[2]
    r, c = x.shape
    n_spl = s.numel()
    ones = torch.ones_like(x, dtype=torch.int64)

    def library(i):
        ids = torch.bucketize(x, s, right=True)
        return torch.zeros((r, n_spl + 1), dtype=torch.int64,
                           device=x.device).scatter_add_(1, ids, ones)

    report.add(pk.KERNEL, err, shape=[r, c], splitters=n_spl,
               ms=cuda_time(lambda i: pk.partition_rows(x, s), KERNEL_ITERS),
               **device_fields(pk.KERNEL.name,
                               lambda i: pk.partition_rows(x, s)),
               plain_ms=cuda_time(lambda i: pk.partition_rows_plain(x, s),
                                  PLAIN_ITERS, 1),
               library_ms=cuda_time(library, KERNEL_ITERS),
               # the least work: a binary search over the splitters sorted
               # once (the count does not depend on their order), then one
               # histogram add per key
               **bound(2 * r * c * 4 + n_spl * 4 + r * (n_spl + 1) * 4,
                       r * c * (n_spl.bit_length() + 1)))
    row = report.rows[pk.KERNEL.name]
    print(f"[partition] {pk.KERNEL.name}: " + ", ".join(
        f"{key} {row.get(key)}" for key in (
            "shape", "splitters", "ms", "device_ms", "device_ms_by_function",
            "plain_ms", "library_ms", "bound_ms", "bound_by")))
    print(f"[partition] phase took {time.perf_counter() - t0:.1f} s")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs import DS1, DS2
    from repro_torch.core import packing
    from repro_torch.data import synthetic_words
    from repro_torch.kernels import execution_provenance
    device = torch.device("cuda")
    t0 = time.perf_counter()
    print(f"[env] {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} {execution_provenance(device)}")
    phase_build()
    words = {name: synthetic_words(n, seed=0) for name, n in
             (("chunk-500", 500), ("chunk-3000", 3000),
              ("DS1", DS1.n_words), ("DS2", DS2.n_words))}
    report = Report()
    phase_kernels(report, device, packing.pack_words(words["DS2"]),
                  packing.pack_words(words["chunk-500"]),
                  packing.pack_words(words["chunk-3000"]))
    phase_run_merges(report, device, packing.pack_words(words["DS2"]))
    phase_main_path(report, device, list(words.items()))
    big_words = synthetic_words(1_048_576, seed=0)
    phase_run_tier(report, device, words["DS2"], big_words)
    phase_partition_and_repairs(report, device, words["DS2"], big_words)
    for name, row in report.rows.items():
        if row["launches"] == 0:
            raise AssertionError(f"{name} was never launched on its path")
    print(f"[done] all phases passed in {time.perf_counter() - t0:.1f} s")
    print(nvidia_smi())
    print(json.dumps({"kernels": list(report.rows.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
