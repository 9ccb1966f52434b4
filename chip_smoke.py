#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout, on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It imports nothing of ``jax`` or ``repro``. Phases, each fatal on failure:

  1. build — compile the seven CUDA sources of ``src/repro_torch/kernels/
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
     plain version and library call or torch tier. The bitonic kernel (B2)
     also runs at every power-of-two column count from 1 to its
     shared-memory cap, and the merge kernel (B4) at every power-of-two
     block, at offsets 0 and ``block``, both for 1, 2, 3, 4, 5, 8 and 9
     lanes of each code and fill; B2 is timed at the run tier's chunk
     blocks (4, 136, 512) beside DS2's local blocks. The distribute kernel
     (B3) runs at 0 to 1,048,577 words of 1 to 8 lanes, with ``n_valid``
     0, ``n - 777`` and ``n``, on words of spread, single and per-warp
     alternating lengths. The OETS kernel (B1) also runs at 1, 17, 33 and
     133 rows of 100, 128 (one warp a row) and 256 columns (a block a row)
     for the same lane counts, codes and fills, each output also the stable
     sort. The merge-path kernel (B5) and its split run at the last
     tournament round of DS2 chunked at 4096 words, and at every
     compare-lane count from 1 to 15 for each fill at the co-rank edges of
     ``adversarial.MERGE_EDGES``, blocks 128 and 256; the k-way kernel (B6),
     its split (the key tournament's rounds on the card) and the gather of
     the runs' lanes at DS2's 57 runs, the split held to its plain version
     and to the torch oracle ``kway_cursors(kway_ranks(...))``, and all
     three at 2, 3, 8, 57, 64, 257 and 1,024 runs of each fill
     (``adversarial.kway_case``), blocks 128 and 256;
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
  3b. fault tolerance — the same chunked sorts with a ``RunStore`` and a
     ``SortSupervisor`` in a temporary directory (``phase_fault_tolerance``):
     DS2 with a store, timed against none, and a resume that sorts no
     chunk; a job failing every chunk sort from chunk 30 on and its
     resume (27 chunk sorts); a damaged store (3 chunk sorts) and a flipped
     bit caught by ``validate='full'``; a supervisor with no fault, timed
     against none, and injected failures of ``ingest_chunk``,
     ``streaming_combine`` and (tournament) ``merge_round``, each
     recovered bit-identically; the million words with a store and its
     resume; a ``ShardStore`` of the merged DS2 run;
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
     plus a scatter-add;
  5. mesh — ``distributed_chunked_sort_lex`` at 8 destinations of the
     card, its spill, resumes, speculation and chaos soak, and the engines
     over NCCL at world size 1 and in 4 gloo rank processes
     (``phase_mesh``);
  6. serve — Granite-MoE 1B at its published width (bf16, weights drawn on
     the card from seed 0) serving 32 requests through
     ``BucketedScheduler(Engine(..., sort_impl='pallas')).run``: every
     request answered with 16 tokens, the admission sort on B1 and the MoE
     dispatch on B1 (decode) and blocksort's B2 and B4 (prefill), with
     tokens/s, prefill and decode medians, padding waste and peak memory;
     then the admission permutation at 32, 200 and 2,000 requests against
     the plain versions' on the CPU, the kernels' dispatch permutation at
     each of the 24 layers of an 8 x 512 prefill against the stable
     argsort's of the same assignments and that prefill's logits against
     the 'xla' dispatch's, and the engine's greedy tokens on the card
     against the CPU's at the smoke config in float32 (``phase_serve``).

Every kernel row carries ``ms`` (CUDA events around 20 back-to-back calls,
so the host's time per call counts where it is longer) and ``device_ms``
(the device's own time per call, from ``torch.profiler`` over the same
calls, traced again where a window lost events; ``device_ms_source`` says
whether the profiler or the CUDA-graph fallback gave it).

Then it prints the card's name and power limit as ``nvidia-smi`` gives them,
one JSON line with every kernel's numbers, and last
``{"ok": true, "device": {...}}``. It exits non-zero, printing no result,
when there is no card or any check fails.
"""

from __future__ import annotations

import json
import os
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
    # one warp a row up to 128 columns, a block a row beyond
    "oets_rows_lex": ("oets_warp_kernel", "oets_rows_kernel"),
    "bitonic_rows_lex": ("bitonic_window_kernel", "bitonic_regs_kernel"),
    # the kernel and the zeroing of its look-back scratch, in one call
    "distribute_rows": ("distribute_kernel", "Memset"),
    "merge_adjacent_lex": ("merge_window_kernel", "merge_regs_kernel"),
    "merge_runs_lex": ("runmerge_kernel",),
    "merge_path_starts": ("runmerge_starts_kernel",),
    "merge_runs_kway": ("kway_kernel",),
    # a round's split and merge, and the cursors after the last round
    "kway_split": ("kway_split_kernel", "kway_round_kernel",
                   "kway_cursor_kernel"),
    "kway_gather": ("kway_gather_kernel",),
    "partition_rows": ("partition_prep_kernel", "partition_kernel"),
}
SWEEP_LANES = (1, 2, 3, 4, 5, 8, 9)
# B1's sweep: 133 rows leave the warp kernel's last block three warps
# without a row; 100 and 128 columns run one warp a row, 256 a block a row
OETS_SWEEP_ROWS = (1, 17, 33, 133)
OETS_SWEEP_COLS = (100, 128, 256)
MERGE_SWEEP_BLOCKS = (128, 256)
DISTRIBUTE_SWEEP_N = (0, 1, 31, 32, 33, 1023, 1024, 1025, 4096, 65_537,
                      230_000, 1_048_577)
SPLITTER_SWEEP = (0, 1, 2, 31, 32, 33, 127, 128, 1000)   # and MAX_SPLITTERS
SPLITTER_SWEEP_COLS = (1, 3, 130, 16_385)
# the chunks of the fault-tolerance phase: the reference's DEFAULT_CHUNK on
# DS2 (57 runs) and the run tier's 16,384 on the million words (64 runs)
FT_CHUNK = 4096
FT_BIG_CHUNK = 16_384
# phase 5: the mesh chunked sort's destinations on this card, the gloo
# ranks of the engine run, the chaos soak's seeds, the engine inputs' seed
MESH_DESTS = 8
MESH_RANKS = 4
MESH_SOAK_SEEDS = 25
MESH_SEED = 11
# phase 6: Granite-MoE 1B served at full width, its admission queues (B1,
# B2, blocksort), one full-width prefill batch's length, and the tolerance
# of its logits between the 'pallas' and 'xla' dispatch, whose permutations
# are equal: two bf16 forwards of the same permutations (at 2^-3, 16 bf16
# steps at 1.0)
SERVE_ARCH = "granite-moe-1b-a400m"
SERVE_REQUESTS = 32
SERVE_MAX_NEW = 16
SERVE_BATCH = 8
SERVE_MAX_SEQ = 1024
ADMISSION_QUEUES = (32, 200, 2000)
DISPATCH_SEQ = 512
DISPATCH_LOGIT_ATOL = 0.125
# the kernels of the serving path: the admission sort and the MoE dispatch
SERVE_PATH = ("oets_rows_lex", "bitonic_rows_lex", "merge_adjacent_lex")


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


def device_time(kernel_name: str, fn, iters: int = KERNEL_ITERS,
                tries: int = 3):
    """Device milliseconds per call of ``fn(i)`` spent in the CUDA functions
    of ``kernel_name`` (:data:`DEVICE_NAMES`), where the number comes from,
    and its split by function: ``torch.profiler``'s CUDA time by kernel
    name over ``iters`` calls after a warm-up ('profiler'), or, where no
    window shows every launch, CUDA events around the replay of a CUDA
    graph of ``iters`` calls, which takes the host's launch cost out of the
    window ('graph events', no split). Every call launches each of its
    functions the same number of times, so a window in which some
    function's event count is not a multiple of ``iters`` (or that shows no
    device time) lost events, and is traced again, up to ``tries``
    windows: a window that lost most of B6's events read it at a quarter
    of its time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    names = DEVICE_NAMES[kernel_name]
    fn(0)
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for i in range(iters):
                fn(i)
            torch.cuda.synchronize()
        split, whole = {}, True
        for ev in prof.key_averages():
            name = next((n for n in names if n in ev.key), None)
            if name is not None:
                t = getattr(ev, "device_time_total", None)
                t = t if t is not None else ev.cuda_time_total
                split[name] = split.get(name, 0.0) + t / iters / 1e3
                whole = whole and ev.count % iters == 0
        if whole and sum(split.values()) > 0:
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
    of :data:`SWEEP_LANES` and each code and fill: the in-thread,
    shuffle and shared-memory stages of its network, and the register-only
    kernel. Returns the largest bit error."""
    import numpy as np
    import torch
    from repro_torch.kernels import adversarial, lex, merge_kernel
    rng = np.random.default_rng(4)
    worst = 0
    for n in SWEEP_LANES:
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


def bitonic_sweep(device) -> int:
    """B2 against its plain version at every power-of-two column count from
    1 to the shared-memory cap, for every lane count of :data:`SWEEP_LANES`
    and each code and fill: the register-only kernel (up to 128 columns),
    then the in-thread, shuffle and shared-memory stages of the window
    kernel. Returns the largest bit error."""
    import numpy as np
    import torch
    from repro_torch.kernels import adversarial, bitonic_kernel, lex
    from repro_torch.kernels._build import SMEM_LIMIT
    rng = np.random.default_rng(6)
    worst = 0
    for n in SWEEP_LANES:
        cap = 1 << ((SMEM_LIMIT // (4 * n)).bit_length() - 1)
        for code_name, code in (("u32", lex.U32), ("i32", lex.I32),
                                ("f32", lex.F32)):
            codes = [code] * n
            for fill in adversarial.FILLS:
                err, cols = 0, 1
                while cols <= cap:
                    x = torch.from_numpy(adversarial.lane_bits(
                        rng, (n, 3, cols), code, fill)).to(device)
                    got = bitonic_kernel.bitonic_rows_lex(x.clone(), codes)
                    want = bitonic_kernel.bitonic_rows_lex_plain(x, codes)
                    torch.cuda.synchronize()
                    err = max(err, bits_err(got, want))
                    cols *= 2
                print(f"[kernels] bitonic_rows_lex sweep {n} lanes "
                      f"{code_name} {fill}, columns 1..{cap}: max_abs_err "
                      f"{err}")
                if err:
                    raise AssertionError(f"bitonic_rows_lex sweep {n} "
                                         f"{code_name} {fill}: kernel and "
                                         "plain version differ")
                worst = max(worst, err)
    return worst


def distribute_sweep(device) -> int:
    """B3 against its plain version at every word count of
    :data:`DISTRIBUTE_SWEEP_N`, for 1 to 8 lanes and each fill of
    ``adversarial.WORD_FILLS``, with ``n_valid`` 0, ``n - 777`` (where
    positive) and ``n``; at 4 and 8 lanes also words that are not 16-byte
    aligned (the scalar loads). Returns the largest error."""
    import numpy as np
    import torch
    from repro_torch.kernels import adversarial, distribute_kernel as dk
    rng = np.random.default_rng(7)
    worst = 0
    top = max(DISTRIBUTE_SWEEP_N)
    for lanes in range(1, 9):
        for fill in adversarial.WORD_FILLS:
            words = torch.from_numpy(adversarial.packed_words(
                rng, top, lanes, fill)).to(device)
            err = 0
            for n in DISTRIBUTE_SWEEP_N:
                cases = [words[:n]]
                if lanes % 4 == 0 and n == 1025:
                    shifted = torch.empty(n * lanes + 1, dtype=torch.int32,
                                          device=device)
                    cases.append(shifted[1:].view(n, lanes).copy_(words[:n]))
                for keys in cases:
                    for n_valid in sorted({0, max(n - 777, 0), n}):
                        got = dk.distribute_rows(keys, n_valid)
                        want = dk.distribute_rows_plain(keys, n_valid)
                        torch.cuda.synchronize()
                        err = max(err, max(bits_err(g, w)
                                           for g, w in zip(got, want)))
            print(f"[kernels] distribute_rows sweep {lanes} lanes {fill}, "
                  f"n {DISTRIBUTE_SWEEP_N[0]}..{top}, n_valid 0, n - 777 and "
                  f"n: max_abs_err {err}")
            if err:
                raise AssertionError(f"distribute_rows sweep {lanes} lanes "
                                     f"{fill}: kernel and plain version "
                                     "differ")
            worst = max(worst, err)
    return worst


def oets_sweep(device) -> int:
    """B1 against its plain version for every lane count of
    :data:`SWEEP_LANES`, each code and fill, at every row count of
    :data:`OETS_SWEEP_ROWS` and column count of :data:`OETS_SWEEP_COLS`:
    the warp kernel and the shared-memory kernel. Each output must also be
    the stable sort (a chain of stable ``torch.sort`` passes), which
    adjacent swaps on a strict compare give. Returns the largest bit
    error."""
    import numpy as np
    import torch
    from repro_torch.kernels import adversarial, lex, oets_kernel
    rng = np.random.default_rng(8)
    worst = 0
    for n in SWEEP_LANES:
        for code_name, code in (("u32", lex.U32), ("i32", lex.I32),
                                ("f32", lex.F32)):
            codes = [code] * n
            for fill in adversarial.FILLS:
                err = 0
                for rows in OETS_SWEEP_ROWS:
                    for cols in OETS_SWEEP_COLS:
                        x = torch.from_numpy(adversarial.lane_bits(
                            rng, (n, rows, cols), code, fill)).to(device)
                        got = oets_kernel.oets_rows_lex(x.clone(), codes)
                        want = oets_kernel.oets_rows_lex_plain(x, codes)
                        stable = lib_sort(x, lex.order_keys(x, codes))
                        torch.cuda.synchronize()
                        err = max(err, bits_err(got, want))
                        if not torch.equal(got, stable):
                            raise AssertionError(
                                f"oets_rows_lex sweep {n} {code_name} {fill} "
                                f"({rows}, {cols}): not the stable sort")
                print(f"[kernels] oets_rows_lex sweep {n} lanes {code_name} "
                      f"{fill}, rows {OETS_SWEEP_ROWS} x columns "
                      f"{OETS_SWEEP_COLS}: max_abs_err {err}")
                if err:
                    raise AssertionError(f"oets_rows_lex sweep {n} "
                                         f"{code_name} {fill}: kernel and "
                                         "plain version differ")
                worst = max(worst, err)
    return worst


def runmerge_sweep(device) -> int:
    """B5's split and merge against their plain versions for every
    compare-lane count from 1 to ``MAX_CMP_LANES`` and each fill, at every
    co-rank edge of ``adversarial.MERGE_EDGES`` (empty runs, runs of one
    element, equal runs, one run wholly below the other, totals on and off
    a block multiple) and blocks :data:`MERGE_SWEEP_BLOCKS`: the starts
    bit for bit, the merged lanes bit for bit. Returns the largest bit
    error."""
    import numpy as np
    import torch
    from repro_torch.kernels import adversarial, runmerge_kernel as rk
    rng = np.random.default_rng(9)
    worst = 0
    for n_cmp in range(1, rk.MAX_CMP_LANES + 1):
        for fill in adversarial.FILLS:
            err = 0
            for edge in adversarial.MERGE_EDGES:
                a, b, codes = adversarial.merge_case(rng, n_cmp, fill, edge)
                da, db = (torch.from_numpy(np.stack(r)).to(device)
                          for r in (a, b))
                sa, sb = da[:n_cmp], db[:n_cmp]
                for block in MERGE_SWEEP_BLOCKS:
                    starts = rk.merge_path_starts(sa, sb, block, codes)
                    want = rk.merge_path_starts_plain(sa, sb, codes, block)
                    got = rk.runmerge(sa, sb, da, db, starts, codes, block)
                    ref = rk.runmerge_plain(sa, sb, da, db, want, codes,
                                            block)
                    torch.cuda.synchronize()
                    err = max(err, bits_err(starts, want), bits_err(got, ref))
            print(f"[kernels] merge_runs_lex sweep {n_cmp} compare lanes "
                  f"{fill}, edges {'/'.join(adversarial.MERGE_EDGES)}, "
                  f"blocks {MERGE_SWEEP_BLOCKS}: split and merge "
                  f"max_abs_err {err}")
            if err:
                raise AssertionError(f"merge_runs_lex sweep {n_cmp} {fill}: "
                                     "kernels and plain versions differ")
            worst = max(worst, err)
    return worst


def kway_sweep(device) -> int:
    """The k-way split's rounds, the gather and B6 against their plain
    versions at every run count of ``adversarial.KWAY_SWEEP`` (2 to
    ``MAX_RUNS``) for each fill, on runs of 0 to 90 elements (empty and
    one-element runs among them), blocks :data:`MERGE_SWEEP_BLOCKS`: the
    cursors bit for bit those of the plain split and of the torch oracle
    (``kway_cursors(kway_ranks(...))``), the gathered lanes the plain
    concatenation's, the merge the plain merge tree's. Returns the largest
    bit error."""
    import numpy as np
    import torch
    from repro_torch import to_device
    from repro_torch.kernels import adversarial, kway_kernel as kk
    worst = 0
    for k in adversarial.KWAY_SWEEP:
        for fill in adversarial.FILLS:
            rng = np.random.default_rng([k, len(fill), 17])
            n_cmp = 1 + k % 5
            runs, codes = adversarial.kway_case(rng, n_cmp, fill, k, 90)
            runs = [tuple(to_device(r, device)) for r in runs]
            ns = [r[0].shape[0] for r in runs]
            oracle = kk.kway_ranks([r[:n_cmp] for r in runs])
            err = 0
            for block in MERGE_SWEEP_BLOCKS:
                cmp, data, cursors, _ = kk.kway_operands(runs, n_cmp, None,
                                                         block)
                got = kk.kway_merge(cmp, data, cursors, codes, block)
                flat = kk.kway_gather_plain(runs)
                plain = kk.kway_starts_plain(flat[:n_cmp], ns, codes, block)
                want = kk.kway_merge_plain(flat[:n_cmp], flat, plain, codes,
                                           block)
                torch.cuda.synchronize()
                err = max(err, bits_err(data, flat), bits_err(cursors, plain),
                          bits_err(cursors, kk.kway_cursors(oracle, block)),
                          bits_err(got, want))
            print(f"[kernels] kway_split sweep k={k} {fill}, {n_cmp} compare "
                  f"lanes, blocks {MERGE_SWEEP_BLOCKS}: split (plain and "
                  f"oracle), gather and merge max_abs_err {err}")
            if err:
                raise AssertionError(f"k-way sweep k={k} {fill}: kernels and "
                                     "plain versions differ")
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
    err = max(err, oets_sweep(device))
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
    # the run tier's chunk shape: a 4096-word chunk bucketed at capacity
    # 4096, blocksort's local sort at its block
    run_block = default_block_size(4096, n_arrays=4)
    xr = stacked_buckets(ds2_keys[:4096], device, lambda cap: 4096).view(
        4, -1, run_block)
    e, got = check_row_kernel(k, bitonic_kernel.bitonic_rows_lex,
                              plain_bitonic, xr, U4, "run-tier chunk blocks")
    check_sorted(k.name, xr, got, U4)
    err = max(err, e, bitonic_sweep(device))

    def bitonic_bound(t):
        a, r, c = t.shape
        m = c.bit_length() - 1
        return bound(2 * a * r * c * 4, r * (c // 2) * m * (m + 1) // 2 * a)

    def lib(t):
        return lib_sort(t, t ^ (-1 << 31))

    run_tier = time_row_kernel(k, bitonic_kernel.bitonic_rows_lex,
                               plain_bitonic, lib, xr, U4)
    run_tier.update(bitonic_bound(xr))
    print(f"[kernels] {k.name} run-tier chunk {tuple(xr.shape)}: " + ", ".join(
        f"{key} {run_tier.get(key)}" for key in (
            "ms", "device_ms", "device_ms_source", "device_ms_by_function",
            "plain_ms", "library_ms", "bound_ms")))
    report.add(k, err, shape=list(xl.shape),
               **time_row_kernel(k, bitonic_kernel.bitonic_rows_lex,
                                 plain_bitonic, lib, xl, U4),
               **bitonic_bound(xl), run_tier_shape=list(xr.shape),
               run_tier={key: run_tier[key] for key in (
                   "ms", "device_ms", "device_ms_source", "plain_ms",
                   "library_ms", "bound_ms")})

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
    err = max(err, distribute_sweep(device))

    def distribute_times(words):
        n = words.shape[0]
        return dict(
            ms=cuda_time(lambda i: distribute_kernel.distribute_rows(words),
                         KERNEL_ITERS),
            **device_fields(k.name, lambda i: distribute_kernel.distribute_rows(
                words)),
            plain_ms=cuda_time(lambda i: distribute_kernel.distribute_rows_plain(
                words, n), PLAIN_ITERS, 1),
            library_ms=None,
            **bound(n * 4 * 4 + 2 * n * 4 + 17 * 4, n * 4))

    # the run tier's chunk: 4096 words, four tiles
    chunk = distribute_times(keys[:4096])
    print(f"[kernels] {k.name} run-tier chunk (4096, 4): " + ", ".join(
        f"{key} {chunk.get(key)}" for key in (
            "ms", "device_ms", "device_ms_source", "device_ms_by_function",
            "plain_ms", "bound_ms")))
    report.add(k, err, shape=list(keys.shape), **distribute_times(keys),
               run_tier_shape=[4096, 4],
               run_tier={key: chunk[key] for key in (
                   "ms", "device_ms", "device_ms_source", "plain_ms",
                   "bound_ms")})
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


def front_end_events(run, expected, tries: int = 5):
    """The names of the device events of one ``run()`` (a warm call
    first), from ``torch.profiler``, from the first window that holds
    ``expected[name]`` events of each CUDA function ``name`` (a window
    that lost events is traced again, up to ``tries`` windows); None when
    no window held them all."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    run()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        names = [e.name.split("(")[0].replace("void ", "")
                 for e in prof.events() if e.device_type == DeviceType.CUDA]
        if all(sum(f in n for n in names) == c for f, c in expected.items()):
            return names
    return None


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

    # B6 at DS2's 57 runs of <= 4096: the operands come through the
    # gather and the split's rounds on the card
    blk = kk.DEFAULT_KWAY_BLOCK
    ops = kk.kway_operands(ext, n_cmp, block=blk)
    total = ops[1].shape[1]
    cmp_runs = [r[:n_cmp] for r in ext]
    ns = [r[0].shape[0] for r in ext]
    codes = ops[3]
    flat = kk.kway_gather_plain(ext)
    plain_cursors = kk.kway_starts_plain(ops[0], ns, codes, blk)
    oracle = kk.kway_cursors(kk.kway_ranks(cmp_runs), blk)
    torch.cuda.synchronize()
    gather_err = bits_err(ops[1], flat)
    split_err = max(bits_err(ops[2], plain_cursors), bits_err(ops[2], oracle))
    print(f"[kernels] kway_gather DS2 {k} runs, {n_arr} arrays: max_abs_err "
          f"{gather_err}; kway_split DS2 {k} runs, {n_cmp} compare lanes: "
          f"max_abs_err {split_err} (plain split and oracle)")
    if gather_err or split_err:
        raise AssertionError("kway_gather or kway_split: kernel and plain "
                             "version differ")
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
    sweep_err = kway_sweep(device)
    ms_engine = cuda_time(lambda i: kk.merge_runs_kway_kernel(
        ext, n_cmp=n_cmp), 3, 1)
    rounds = math.ceil(math.log2(k))
    # one front-end call's device events: every round's split and merge,
    # the cursors, the gather and B6 (the launch counters say how many)
    _, counts = launch_counts(lambda: kk.merge_runs_kway_kernel(
        ext, n_cmp=n_cmp))
    expected = {"kway_split_kernel": counts[kk.SPLIT_KERNEL.name],
                "kway_round_kernel": counts[kk.SPLIT_KERNEL.name],
                "kway_cursor_kernel": 1,
                "kway_gather_kernel": counts[kk.GATHER_KERNEL.name],
                "kway_kernel": counts[kk.KERNEL.name]}
    events = front_end_events(lambda: kk.merge_runs_kway_kernel(
        ext, n_cmp=n_cmp), expected)
    if events is None:
        print(f"[kernels] merge_runs_kway_kernel front end, DS2 {k} runs: "
              "device events not measured (no profiler window held every "
              "launch)")
    else:
        launched = [n for n in events
                    if not n.startswith(("Memcpy", "Memset"))]
        print(f"[kernels] merge_runs_kway_kernel front end, DS2 {k} runs: "
              f"{len(events)} device events, {len(launched)} kernels (at "
              f"most {2 * rounds + 4}): {sorted(Counter(events).items())}")
        if len(launched) > 2 * rounds + 4:
            raise AssertionError("merge_runs_kway_kernel launched more "
                                 "kernels than the split's rounds, the "
                                 "gather and B6")
    nblocks = -(-total // blk)
    report.add(kk.KERNEL, max(err, sweep_err), shape=[n_arr, total], runs=k,
               block=blk,
               ms=cuda_time(lambda i: kk.kway_merge(*ops, blk), KERNEL_ITERS),
               **device_fields(kk.KERNEL.name,
                               lambda i: kk.kway_merge(*ops, blk)),
               plain_ms=cuda_time(lambda i: kk.kway_merge_plain(*ops, blk),
                                  PLAIN_ITERS, 1),
               torch_tier_ms=cuda_time(lambda i: kk.merge_runs_kway_take(
                   ext, n_cmp=n_cmp), KERNEL_ITERS),
               engine_ms=ms_engine,
               front_end_device_events=None if events is None else len(events),
               library_ms=None,
               **bound(2 * n_arr * total * 4 + ops[2].numel() * 4,
                       total * rounds * n_cmp))

    def split(i):
        return kk.kway_starts(ops[0], ns, codes, blk)

    # the kernels alone, on a plan uploaded once: the device's own time,
    # and what a CUDA graph can replay
    lanes = kk._word_lanes(ext)
    rounds_plan = kk.split_plan(ns)
    plan, addr = kk._device_plan(device, rounds_plan, kk._bases(ns), lanes)

    def split_kernels(i):
        return kk._split_rounds(ops[0], codes, rounds_plan, addr, k, blk)

    def gather_kernel(i):
        return kk._gather(lanes, addr, total, device)

    torch.cuda.synchronize()
    base_bytes = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    split(0)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base_bytes
    report.add(kk.SPLIT_KERNEL, max(split_err, sweep_err),
               shape=[n_cmp, total], runs=k, block=blk,
               ms=cuda_time(split, KERNEL_ITERS),
               **device_fields(kk.SPLIT_KERNEL.name, split_kernels),
               plain_ms=cuda_time(lambda i: kk.kway_starts_plain(
                   ops[0], ns, codes, blk), PLAIN_ITERS, 1),
               # the yardstick: the torch split the port ran before these
               # kernels (kway_ranks' merge_take_packed rounds, then a
               # searchsorted a run)
               library_ms=cuda_time(lambda i: kk.kway_cursors(
                   kk.kway_ranks(cmp_runs), blk), PLAIN_ITERS, 1),
               # the least: the compare lanes read once, the cursors
               # written; the design's floor: every round reads and writes
               # the compare lanes' keys and the index lane
               **bound((n_cmp * total + k * (nblocks + 1)) * 4,
                       total * rounds * n_cmp),
               rounds_bound_ms=2 * (n_cmp + 1) * total * 4 * rounds
               / HBM_BYTES_PER_S * 1e3,
               peak_bytes=peak)
    gather_err = max(gather_err, bits_err(kk.kway_gather(ext), flat))
    report.add(kk.GATHER_KERNEL, max(gather_err, sweep_err),
               shape=[n_arr, total], runs=k,
               ms=cuda_time(lambda i: kk.kway_gather(ext), KERNEL_ITERS),
               **device_fields(kk.GATHER_KERNEL.name, gather_kernel),
               plain_ms=cuda_time(lambda i: kk.kway_gather_plain(ext),
                                  KERNEL_ITERS),
               # no one PyTorch call concatenates many runs' lanes into a
               # stack (the plain version is a torch.cat a lane)
               library_ms=None,
               **bound(2 * n_arr * total * 4, 0))

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
    err = max(err, runmerge_sweep(device))

    # the split at the same merge: the kernel's starts (merge_operands ran
    # it) against the plain torch split's, then both timed
    sk = rk.SPLIT_KERNEL
    sa, sb, codes = ops[0], ops[1], ops[5]
    split_err = bits_err(ops[4], rk.merge_path_starts_plain(sa, sb, codes,
                                                            blk))
    print(f"[kernels] {sk.name} DS2 last round, {len(codes)} compare lanes: "
          f"max_abs_err {split_err}")
    if split_err:
        raise AssertionError(f"{sk.name}: kernel and plain version differ")
    nbounds = ops[4].shape[1]
    steps = min(sa.shape[1], sb.shape[1]).bit_length()

    def split(i):
        return rk.merge_path_starts(sa, sb, blk, codes)

    def torch_split(i):
        return rk.merge_path_starts_plain(sa, sb, codes, blk)

    report.add(sk, split_err, shape=[len(codes), sa.shape[1], sb.shape[1]],
               block=blk, ms=cuda_time(split, KERNEL_ITERS),
               **device_fields(sk.name, split),
               plain_ms=cuda_time(torch_split, PLAIN_ITERS, 1),
               # the yardstick: the torch split (the plain version) on the
               # card, the split the port ran before this kernel
               library_ms=cuda_time(torch_split, KERNEL_ITERS),
               # the least: a boundary's search reads one lane of a and of
               # b a step, then writes its two starts
               **bound(nbounds * (steps * 2 + 2) * 4, nbounds * steps))

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
    for name in (rk.KERNEL.name, rk.SPLIT_KERNEL.name, kk.KERNEL.name,
                 kk.SPLIT_KERNEL.name, kk.GATHER_KERNEL.name):
        row = report.rows[name]
        print(f"[kernels] {name}: " + ", ".join(
            f"{key} {row.get(key)}" for key in (
                "shape", "ms", "device_ms", "device_ms_by_function",
                "plain_ms", "library_ms", "torch_tier_ms", "engine_ms",
                "bound_ms", "bound_by", "rounds_bound_ms", "peak_bytes")))


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
        ("DS2 chunked, k-way", ds2_words, 4096, "auto",
         ("merge_runs_kway", "kway_split", "kway_gather"),
         lambda: chunked_sort_words(ds2_words, chunk_size=4096,
                                    merge_engine="auto", device=device)),
        ("DS2 chunked, tournament", ds2_words, 4096, "tournament",
         ("merge_runs_lex", "merge_path_starts"),
         lambda: chunked_sort_words(ds2_words, chunk_size=4096,
                                    merge_engine="tournament",
                                    device=device)),
        ("1M words chunked, k-way, validate=full", big_words, 16384, "auto",
         ("merge_runs_kway", "kway_split", "kway_gather"),
         lambda: chunked_sort_packed(big_keys, chunk_size=16384,
                                     validate="full", device=device)),
    )
    for name, words, chunk, engine, merge_kernels, run in cases:
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
                      "merge_adjacent_lex") + merge_kernels:
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


def wall(run, reps: int = 1):
    """Median host seconds of ``reps`` calls of ``run()``, each ended by a
    synchronize."""
    import torch
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def dir_bytes(root) -> int:
    return sum(f.stat().st_size for f in Path(root).rglob("*") if f.is_file())


def phase_fault_tolerance(report, device, ds2_words, big_words):
    """The fault-tolerant chunked sort through its entry points
    (``store=``, ``supervisor=``), in a temporary directory, every result
    checked against Python's shortlex order and every run's chunk sorts
    counted by B3's launches (one a chunk sort): DS2 with a ``RunStore``
    (timed against no store, its bytes on disk, one ``put``), a resume of
    the full store (no chunk sort), a kill from chunk 30 on and its resume
    (27 chunk sorts), a damaged store (a lost run, a half-written one, a
    truncated file: 3 chunk sorts) and a flipped bit that
    ``validate='full'`` must catch, a supervisor with no fault (timed
    against none) and injected transient failures of each stage, the
    million words with a store and its resume; then a ``ShardStore`` of
    the merged DS2 run, gated by ``check_sharded`` and read back whole."""
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch
    from repro_torch import to_numpy
    from repro_torch.core import packing
    from repro_torch.pipeline import (RunManifest, RunStore, ShardedRun,
                                      ShardStore, SortedRun, ValidationError,
                                      check_sharded, chunked_sort_packed,
                                      chunked_sort_words, sorted_run)
    from repro_torch.runtime import (RetryPolicy, SortSupervisor,
                                     StageFailure, StageFailureInjector)
    t_phase = time.perf_counter()
    oracle = shortlex(ds2_words)
    ds2_keys = packing.pack_words(ds2_words)
    big_keys = packing.pack_words(big_words)
    big_oracle = packing.pack_words(shortlex(big_words), width=16)
    kway = ("merge_runs_kway", "kway_split", "kway_gather")
    n_chunks = -(-len(ds2_words) // FT_CHUNK)

    def drive(name, run, sorts, want=oracle, merge_kernels=kway):
        """``run()`` once with the counters read around it; its output
        must be ``want`` (words, or a run's packed keys) and its chunk
        sorts ``sorts``."""
        out, counts = launch_counts(run)
        ok = (out == want if isinstance(want, list) else
              np.array_equal(to_numpy(out.keys), want))
        if not ok:
            raise AssertionError(f"{name}: not the shortlex order")
        if counts["distribute_rows"] != sorts:
            raise AssertionError(f"{name}: {counts['distribute_rows']} "
                                 f"chunk sorts, expected {sorts}")
        for kname in merge_kernels:
            if counts[kname] == 0:
                raise AssertionError(f"{name}: {kname} never launched")
        for kname, c in counts.items():
            report.rows[kname]["launches"] += c
        print(f"[fault] {name}: {sorts} chunk sorts, launches {counts}; "
              "shortlex oracle: equal")
        return out

    def words(**kw):
        return lambda: chunked_sort_words(ds2_words, chunk_size=FT_CHUNK,
                                          device=device, **kw)

    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "ds2")
        # 1. a store: the first call writes every run
        drive("DS2 chunked, k-way, store", words(store=RunStore(root)),
              n_chunks)
        if RunStore(root).completed() != list(range(n_chunks)):
            raise AssertionError("the store does not hold every run")
        t_plain, t_store = [], []
        for i in range(3):        # in turns; each store call writes anew
            t_plain.append(wall(words()))
            t_store.append(wall(words(store=RunStore(
                os.path.join(tmp, f"timed{i}")))))
        chunk0 = sorted_run(ds2_keys[:FT_CHUNK], capacity=FT_CHUNK,
                            device=device)
        man0 = RunManifest.from_run(chunk0, 0)
        copies, writes = [], []
        for i in range(5):        # the two halves of a put, as ingest runs it
            put_store = RunStore(os.path.join(tmp, f"put{i}"))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            on_host = SortedRun(lengths=to_numpy(chunk0.lengths),
                                keys=to_numpy(chunk0.keys),
                                packed=tuple(to_numpy(chunk0.packed)))
            t1 = time.perf_counter()
            put_store.put(man0, on_host)
            writes.append(time.perf_counter() - t1)
            copies.append(t1 - t0)
        print(f"[fault] DS2 chunked, k-way: whole call median "
              f"{statistics.median(t_plain) * 1e3:.3f} ms without a store "
              f"{[round(t * 1e3, 3) for t in t_plain]}, "
              f"{statistics.median(t_store) * 1e3:.3f} ms with one "
              f"{[round(t * 1e3, 3) for t in t_store]}; {n_chunks} runs, "
              f"{dir_bytes(root)} B on disk; one put of a {FT_CHUNK}-word "
              f"run from the card, medians over 5: the copy to the host "
              f"{statistics.median(copies) * 1e3:.3f} ms "
              f"{[round(t * 1e3, 3) for t in copies]}, the files "
              f"{statistics.median(writes) * 1e3:.3f} ms "
              f"{[round(t * 1e3, 3) for t in writes]}")
        # 2. a resume of the full store sorts nothing
        drive("DS2 resume of the full store", words(store=RunStore(root)), 0)
        t_resume = wall(words(store=RunStore(root)), reps=3)
        print(f"[fault] DS2 resume of the full store: median "
              f"{t_resume * 1e3:.3f} ms over 3")
        # 3. a job that dies at chunk 30, and its resume
        kill = os.path.join(tmp, "kill")
        sup = SortSupervisor(policy=RetryPolicy(max_retries=0),
                             injector=StageFailureInjector(fail_at={
                                 "ingest_chunk": set(range(30, n_chunks))}))
        try:
            words(store=RunStore(kill), supervisor=sup)()
            raise AssertionError("the injected failure did not stop the job")
        except StageFailure:
            pass
        if RunStore(kill).completed() != list(range(30)):
            raise AssertionError("the killed job's store does not hold "
                                 "exactly runs 0..29")
        drive("DS2 resume after a kill at chunk 30",
              words(store=RunStore(kill)), n_chunks - 30)
        if RunStore(kill).completed() != list(range(n_chunks)):
            raise AssertionError("the resume did not complete the store")
        # 4. damage: a lost run, a half-written one, a truncated file
        shutil.rmtree(os.path.join(root, "step_5"))
        os.rename(os.path.join(root, "step_12"),
                  os.path.join(root, ".tmp_12"))
        victim = os.path.join(root, "step_20", "keys.npy")
        with open(victim, "r+b") as f:
            f.truncate(os.path.getsize(victim) // 2)
        drive("DS2 resume of a damaged store", words(store=RunStore(root)),
              3)
        keys_file = os.path.join(root, "step_40", "keys.npy")
        good = np.load(keys_file)
        bad = good.copy()
        bad[3, 0] ^= np.uint32(1 << 7)
        np.save(keys_file, bad)
        try:
            words(store=RunStore(root), validate="full")()
            raise AssertionError("a flipped bit in a stored run passed "
                                 "validate='full'")
        except ValidationError as e:
            print(f"[fault] a flipped bit in run 40's keys.npy: "
                  f"ValidationError ({e})")
        np.save(keys_file, good)
        # 5. the supervisor: no fault against none, then injected failures
        t_none, t_sup = [], []
        for _ in range(3):
            t_none.append(wall(words()))
            t_sup.append(wall(words(supervisor=SortSupervisor())))
        print(f"[fault] DS2 chunked, k-way: whole call median "
              f"{statistics.median(t_none) * 1e3:.3f} ms without a "
              f"supervisor {[round(t * 1e3, 3) for t in t_none]}, "
              f"{statistics.median(t_sup) * 1e3:.3f} ms with one and no "
              f"fault {[round(t * 1e3, 3) for t in t_sup]}")
        for engine, fail_at, kernels in (
                ("auto", {"ingest_chunk": {0, 2}, "streaming_combine": {0}},
                 kway),
                ("tournament", {"merge_round": {1}},
                 ("merge_runs_lex", "merge_path_starts"))):
            sleeps = []
            sup = SortSupervisor(injector=StageFailureInjector(
                fail_at=fail_at), sleep=sleeps.append)
            drive(f"DS2 chunked, {engine}, failures at {fail_at}",
                  words(supervisor=sup, merge_engine=engine), n_chunks,
                  merge_kernels=kernels)
            want = [(stage, "retry") for stage in fail_at
                    for _ in fail_at[stage]]
            got = [(e.stage, e.action) for e in sup.events]
            if got != want or sleeps:
                raise AssertionError(f"supervisor events {got} (sleeps "
                                     f"{sleeps}), expected {want}")
        # 6. the million words with a store, and its resume
        big = os.path.join(tmp, "big")

        def big_run():
            return chunked_sort_packed(big_keys, chunk_size=FT_BIG_CHUNK,
                                       validate="full", store=RunStore(big),
                                       device=device)

        t0 = time.perf_counter()
        drive("1M words chunked, validate=full, store", big_run,
              -(-len(big_words) // FT_BIG_CHUNK), big_oracle)
        t_big = time.perf_counter() - t0
        t0 = time.perf_counter()
        drive("1M words resume of the full store", big_run, 0, big_oracle)
        t_big_resume = time.perf_counter() - t0
        print(f"[fault] 1M words chunked, validate=full: first call with a "
              f"store {t_big * 1e3:.3f} ms, {dir_bytes(big)} B on disk; "
              f"full resume {t_big_resume * 1e3:.3f} ms (one call each, "
              "counters read)")
        # the shard store: the merged DS2 run (the packed front end resumes
        # the words front end's store) cut into four destinations
        merged = drive("DS2 packed, resume of the words' store",
                       lambda: chunked_sort_packed(ds2_keys,
                                                   chunk_size=FT_CHUNK,
                                                   store=RunStore(root),
                                                   device=device), 0,
                       packing.pack_words(oracle))
        shards = ShardStore(os.path.join(tmp, "shards"))
        n = len(ds2_words)
        cuts = [0, 1, n // 4, n // 4, n]
        shard_mans = []
        for dest, (lo, hi) in enumerate(zip(cuts, cuts[1:])):
            part = SortedRun(lengths=merged.lengths[lo:hi],
                             keys=merged.keys[lo:hi])
            shard_mans.append(RunManifest.from_run(part, dest))
            shards.put(shard_mans[-1], part)
        store = RunStore(root)
        check_sharded([store.manifest(i) for i in store.completed()],
                      shard_mans, mode="full")
        whole = ShardedRun(store=shards, manifests=tuple(shard_mans)).to_run(
            validate="full", device=device)
        if not (torch.equal(whole.lengths, merged.lengths) and torch.equal(
                whole.keys.view(torch.int32), merged.keys.view(torch.int32))):
            raise AssertionError("ShardedRun.to_run differs from the run")
        print("[fault] ShardStore of the merged DS2 run (4 destinations, "
              "one empty): check_sharded('full') passed, to_run on the "
              "card equal")
    print(f"[fault] phase took {time.perf_counter() - t_phase:.1f} s")


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


# --- phase 5 ----------------------------------------------------------------

def mesh_engine_inputs(workdir):
    """The engine runs' inputs, ``(name, lanes)``: DS2's shortlex tuple
    (length, 4 key lanes, an iota payload), read from ``ds2_tuple.npz`` in
    ``workdir``; 8 x 4096 int32 keys; and 10,001 int32 keys (not divisible
    by the ranks)."""
    import numpy as np
    rng = np.random.default_rng(MESH_SEED)
    ds2 = np.load(Path(workdir) / "ds2_tuple.npz")
    return [("DS2 shortlex tuple", [ds2[f"lane{i}"]
                                    for i in range(len(ds2.files))]),
            ("8 x 4096 int32", [rng.integers(-10**6, 10**6, 8 * 4096)
                                .astype(np.int32)]),
            ("10,001 int32", [rng.integers(0, 50, 10_001).astype(np.int32)])]


def ds2_tuple(ds2_words):
    """DS2's shortlex tuple as numpy lanes: byte lengths (int32), the 4
    packed key lanes (uint32) and an iota payload (uint32)."""
    import numpy as np
    from repro_torch.core import packing
    keys = packing.pack_words(ds2_words)
    lengths = np.asarray([len(w.encode()) for w in ds2_words], np.int32)
    return ([lengths] + [np.ascontiguousarray(keys[:, l])
                         for l in range(keys.shape[1])]
            + [np.arange(len(ds2_words), dtype=np.uint32)])


def check_engine_output(name, lanes, out):
    """``out`` must be ``lanes`` lex-sorted (lane 0 most significant): the
    whole tuple is distinct or integer, so the order is unique."""
    import numpy as np
    from repro_torch import to_numpy
    order = np.lexsort(tuple(reversed(lanes)))
    for i, (got, lane) in enumerate(zip(out, lanes)):
        if not np.array_equal(to_numpy(got), lane[order]):
            raise AssertionError(f"{name}: lane {i} is not the lex order")


MESH_ENGINES = (("odd_even", "bitonic"), ("odd_even", "take"),
                ("odd_even", "resort"), ("sample", "bitonic"))


def mesh_rank(rank: int, world: int, workdir: str) -> int:
    """One rank of phase 5's engine run: joins a gloo group of ``world``
    processes on ``cuda:0`` (its collectives staged through the host), runs
    both engines and every odd-even merge on each input of
    :func:`mesh_engine_inputs`, checks its own output, and prints its
    kernel launches and its times."""
    import datetime
    import torch
    import torch.distributed as dist
    from repro_torch.core.distributed import distributed_sort_lex
    from repro_torch.parallel import make_mesh
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    dist.init_process_group(
        "gloo", init_method=f"file://{workdir}/rendezvous", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=120))
    try:
        mesh = make_mesh((world,), ("data",), "cpu")
        times = {}
        for name, lanes in mesh_engine_inputs(workdir):
            for engine, merge in MESH_ENGINES:
                out, counts = launch_counts(lambda: distributed_sort_lex(
                    lanes, mesh, engine=engine, merge=merge, device=device))
                check_engine_output(f"rank {rank}, {name}, {engine}, "
                                    f"{merge}", lanes, out)
                times[f"{name}, {engine}, {merge}"] = wall(
                    lambda: distributed_sort_lex(lanes, mesh, engine=engine,
                                                 merge=merge, device=device))
                print("MESH_LAUNCHES " + json.dumps(counts), flush=True)
        print("MESH_TIMES " + json.dumps(times), flush=True)
    finally:
        dist.destroy_process_group()
    return 0


def run_mesh_ranks(world: int, workdir: str, timeout: float = 240):
    """Start ``world`` ranks of :func:`mesh_rank` on this card and join
    them within ``timeout`` seconds; kill them all and fail if one fails.
    Returns each rank's output (kept in ``workdir/rank<r>.log``)."""
    logs = [open(os.path.join(workdir, f"rank{r}.log"), "w+")
            for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--mesh-rank",
         str(r), str(world), workdir], stdout=logs[r],
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = []
    for f in logs:
        f.seek(0)
        outs.append(f.read())
        f.close()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        raise AssertionError(f"mesh ranks {bad} failed (codes "
                             f"{[procs[r].returncode for r in bad]}):\n"
                             + outs[bad[0]][-4000:])
    return outs


def phase_mesh(report, device, ds2_words, big_words):
    """The mesh tier through its entry points (``core.distributed``), the
    launch counters read around every driven run: DS2 and the million words
    through ``distributed_chunked_sort_lex`` at 8 destinations of this card
    (k-way and tournament combines, ``validate='full'`` once), each equal
    to ``chunked_sort_packed`` and to Python's shortlex order, DS2 timed
    whole (median of 3) and staged (ingest, exchange, combine); a
    ``ShardStore`` spill and its resume (no destination merge), a kill
    between the exchange and the combine and its resume, a speculative
    combine with one slow destination, and the 25-seed chaos soak; then the
    engines: ``distributed_sort_lex`` at world size 1 over NCCL in this
    process, and in ``MESH_RANKS`` processes on this card over gloo (both
    engines, every odd-even merge; each rank checks its own output and
    reports its launches)."""
    import datetime
    import tempfile
    from unittest import mock

    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch import to_numpy
    from repro_torch.core import packing
    from repro_torch.core.distributed import (_exchange, _ingest_runs,
                                              distributed_chunked_sort_lex,
                                              distributed_sort_lex)
    from repro_torch.parallel import make_mesh
    from repro_torch.pipeline import (ShardedRun, ShardStore, RunStore,
                                      chunked_sort_packed)
    from repro_torch.pipeline import merge as merge_mod
    from repro_torch.runtime import (ProcessKilled, SortSupervisor,
                                     SpeculationPolicy, StageFailureInjector,
                                     StragglerMonitor, chaos_soak)
    t_phase = time.perf_counter()
    devs = [device] * MESH_DESTS
    ds2_keys = packing.pack_words(ds2_words)
    ds2_oracle = packing.pack_words(shortlex(ds2_words))
    ds2_chunked = chunked_sort_packed(ds2_keys, device=device)
    kway = ("merge_runs_kway", "kway_split", "kway_gather")
    tourney = ("merge_runs_lex", "merge_path_starts")

    def drive(name, run, want, merge_kernels=(), sorts=None):
        """``run()`` once with the counters read around it; its gathered
        (or materialised) keys must be ``want``."""
        out, counts = launch_counts(run)
        got = out.to_run(device=device) if isinstance(out, ShardedRun) \
            else out
        if not np.array_equal(to_numpy(got.keys), want):
            raise AssertionError(f"{name}: not the shortlex order")
        for kname in merge_kernels:
            if counts[kname] == 0:
                raise AssertionError(f"{name}: {kname} never launched")
        if sorts is not None and counts["distribute_rows"] != sorts:
            raise AssertionError(f"{name}: {counts['distribute_rows']} "
                                 f"chunk sorts, expected {sorts}")
        for kname, c in counts.items():
            report.rows[kname]["launches"] += c
        print(f"[mesh] {name}: launches {counts}; shortlex oracle: equal")
        return got

    def mesh_sort(keys, **kw):
        return lambda: distributed_chunked_sort_lex(keys, devices=devs, **kw)

    # DS2 across 8 destinations, each engine
    for label, engine, kernels, kw in (
            ("k-way", "auto", kway, {}),
            ("tournament", "tournament", tourney, {}),
            ("k-way, validate=full", "auto", kway, {"validate": "full"})):
        name = f"DS2 at {MESH_DESTS} destinations, {label}"
        run = mesh_sort(ds2_keys, merge_engine=engine, **kw)
        got = drive(name, run, ds2_oracle, kernels, MESH_DESTS)
        if not (torch.equal(got.lengths, ds2_chunked.lengths) and torch.equal(
                got.keys.view(torch.int32),
                ds2_chunked.keys.view(torch.int32))):
            raise AssertionError(f"{name}: differs from chunked_sort_packed")
        times = [wall(run) for _ in range(3)]
        t0 = time.perf_counter()
        runs, _ = _ingest_runs(ds2_keys, devs, algorithm="pallas",
                               on_overflow="raise", store=None,
                               supervisor=None, need_manifest=False)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        per_dest = _exchange([r.lanes() for r in runs],
                             [r.cmp_lanes() for r in runs], devs, 8)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        for sub_lanes, sub_cmps in per_dest:
            merge_mod.merge_runs(sub_lanes, engine=engine, cmp_runs=sub_cmps)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        incoming = [sum(int(s[0].shape[0]) for s in sub)
                    for sub, _ in per_dest]
        print(f"[mesh] {name}: whole call median "
              f"{statistics.median(times) * 1e3:.3f} ms "
              f"{[round(t * 1e3, 3) for t in times]} "
              f"({len(ds2_words) / statistics.median(times):.0f} words/s); "
              f"staged: ingest {(t1 - t0) * 1e3:.3f} ms, exchange "
              f"{(t2 - t1) * 1e3:.3f} ms, combine {(t3 - t2) * 1e3:.3f} ms; "
              f"destinations receive {incoming}; chunked_sort_packed: equal")

    # the million words at 8 destinations
    big_keys = packing.pack_words(big_words)
    big_oracle = packing.pack_words(shortlex(big_words), width=16)
    big_run = mesh_sort(big_keys)
    drive(f"1M words at {MESH_DESTS} destinations, k-way", big_run,
          big_oracle, kway, MESH_DESTS)
    print(f"[mesh] 1M words at {MESH_DESTS} destinations, k-way: one call "
          f"{wall(big_run) * 1e3:.3f} ms")

    def counting_merges():
        return mock.patch.object(merge_mod, "merge_runs",
                                 side_effect=merge_mod.merge_runs)

    with tempfile.TemporaryDirectory() as tmp:
        # the spill, and a resume that merges no destination
        shards = os.path.join(tmp, "spill")
        drive("DS2 spill to a ShardStore, validate=full",
              mesh_sort(ds2_keys, shard_store=ShardStore(shards),
                        validate="full"), ds2_oracle, kway, MESH_DESTS)
        with counting_merges() as merges:
            drive("DS2 spill resume", mesh_sort(
                ds2_keys, shard_store=ShardStore(shards), validate="full"),
                ds2_oracle, (), MESH_DESTS)
        if merges.call_count != 0:
            raise AssertionError(f"the spill resume merged "
                                 f"{merges.call_count} destination(s)")
        # a kill between the exchange and the combine, and its resume
        runs_dir, kill_dir = (os.path.join(tmp, "runs"),
                              os.path.join(tmp, "kill"))
        sup = SortSupervisor(injector=StageFailureInjector(
            kill_at={"streaming_combine": {2}}))
        try:
            mesh_sort(ds2_keys, store=RunStore(runs_dir),
                      shard_store=ShardStore(kill_dir), supervisor=sup)()
            raise AssertionError("the injected kill did not stop the job")
        except ProcessKilled:
            pass
        if ShardStore(kill_dir).completed() != [0, 1]:
            raise AssertionError("the killed job's shard store does not "
                                 "hold exactly destinations 0 and 1")
        with counting_merges() as merges:
            drive("DS2 resume after a kill in the combine", mesh_sort(
                ds2_keys, store=RunStore(runs_dir),
                shard_store=ShardStore(kill_dir), validate="full"),
                ds2_oracle, kway, 0)
        if merges.call_count != MESH_DESTS - 2:
            raise AssertionError(f"the resume merged {merges.call_count} "
                                 f"destinations, expected {MESH_DESTS - 2}")
        # a speculative combine with one slow destination
        inj = StageFailureInjector(slow_at={"streaming_combine": {5: 0.5}})
        sup = SortSupervisor(injector=inj, speculation=SpeculationPolicy(
            monitor=StragglerMonitor(warmup=3, min_ratio=3.0),
            min_wait=0.05))
        drive("DS2 speculative combine, destination 5 slow",
              mesh_sort(ds2_keys, supervisor=sup, validate="full"),
              ds2_oracle, kway, MESH_DESTS)
        actions = [e.action for e in sup.events]
        if "speculate" not in actions or \
                "speculation_confirmed" not in actions:
            raise AssertionError(f"no confirmed speculation: {actions}")
        # the chaos soak
        soak_keys = packing.pack_words(synthetic_soak_words())
        t0 = time.perf_counter()
        reports, counts = launch_counts(lambda: chaos_soak(
            soak_keys, seeds=range(MESH_SOAK_SEEDS),
            workdir=os.path.join(tmp, "soak"), devices=devs,
            num_devices=MESH_DESTS))
        bad = [(r.seed, r.first_error, r.detail) for r in reports
               if not r.ok]
        if bad:
            raise AssertionError(f"chaos soak: {bad}")
        for kname, c in counts.items():
            report.rows[kname]["launches"] += c
        print(f"[mesh] chaos soak: {MESH_SOAK_SEEDS} seeds over "
              f"{MESH_DESTS} destinations of this card, every seed ok "
              f"({sum(r.resumed for r in reports)} resumed, "
              f"{sum(len(r.fired) for r in reports)} faults fired, "
              f"{sum(len(r.damaged) for r in reports)} damages) in "
              f"{time.perf_counter() - t0:.1f} s; launches {counts}")

    # the engines: world size 1 over NCCL in this process
    lanes = ds2_tuple(ds2_words)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "nccl", init_method=f"file://{tmp}/rendezvous", rank=0,
            world_size=1, timeout=datetime.timedelta(seconds=120))
        try:
            mesh = make_mesh((1,), ("data",), "cuda")
            for engine in ("odd_even", "sample"):
                name = f"DS2 shortlex tuple, {engine}, 1 rank over NCCL"
                out, counts = launch_counts(lambda: distributed_sort_lex(
                    lanes, mesh, engine=engine, device=device))
                check_engine_output(name, lanes, out)
                for kname, c in counts.items():
                    report.rows[kname]["launches"] += c
                t = wall(lambda: distributed_sort_lex(
                    lanes, mesh, engine=engine, device=device), reps=3)
                print(f"[mesh] {name}: median {t * 1e3:.3f} ms over 3; "
                      f"launches {counts}; lex order: equal")
        finally:
            dist.destroy_process_group()
        # ... and MESH_RANKS processes on this card over gloo
        np.savez(os.path.join(tmp, "ds2_tuple.npz"),
                 **{f"lane{i}": a for i, a in enumerate(lanes)})
        t0 = time.perf_counter()
        outs = run_mesh_ranks(MESH_RANKS, tmp)
        total = Counter()
        for r, text in enumerate(outs):
            for line in text.splitlines():
                if line.startswith("MESH_LAUNCHES "):
                    total.update(json.loads(line.split(" ", 1)[1]))
                elif line.startswith("MESH_TIMES ") and r == 0:
                    times = json.loads(line.split(" ", 1)[1])
                    for case, t in times.items():
                        print(f"[mesh] {MESH_RANKS} gloo ranks on this card, "
                              f"{case}: {t * 1e3:.3f} ms (rank 0, one call; "
                              "collectives staged through the host)")
        for kname, c in total.items():
            report.rows[kname]["launches"] += c
        for kname in ("bitonic_rows_lex", "merge_adjacent_lex",
                      "merge_runs_lex"):
            if total[kname] == 0:
                raise AssertionError(f"the gloo ranks never launched "
                                     f"{kname}")
        print(f"[mesh] {MESH_RANKS} gloo ranks: every rank's output in lex "
              f"order; launches over all ranks {dict(total)}; "
              f"{time.perf_counter() - t0:.1f} s with the processes' start")
    print(f"[mesh] phase took {time.perf_counter() - t_phase:.1f} s")


# --- phase 6 ----------------------------------------------------------------

def serve_prompts(vocab: int):
    """The wave's prompts: lengths ``default_rng(0).integers(16, 513)``,
    tokens from the same generator."""
    import numpy as np
    rng = np.random.default_rng(0)
    lengths = rng.integers(16, 513, SERVE_REQUESTS)
    return [rng.integers(1, vocab, int(l)).tolist() for l in lengths]


def admission_queue(n: int, seed: int):
    """``n`` requests whose lengths, first and second tokens tie often (a
    few values each), so the payload tie-break decides."""
    import numpy as np
    from repro_torch.serve import Request
    rng = np.random.default_rng(seed)
    return [Request(i, rng.integers(0, 4, int(rng.integers(16, 20))).tolist())
            for i in range(n)]


def timed(fn, times: list):
    """``fn`` with its calls timed on the host clock between two device
    synchronizations, each time appended to ``times`` in ms."""
    import torch

    def run(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        return out
    return run


def granite_full_width(device):
    """Granite-MoE 1B at its published dimensions (bfloat16) on
    ``device``, weights drawn from a seeded ``torch.Generator``; returns
    ``(cfg, lm, seconds)``."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_lm
    cfg = get_config(SERVE_ARCH)
    t0 = time.perf_counter()
    lm = init_lm(cfg, seed=0, device=device)
    torch.cuda.synchronize()
    return cfg, lm, time.perf_counter() - t0


def used(runs: dict) -> dict:
    """The launch counts of the kernels that ran."""
    return {k: c for k, c in runs.items() if c}


def recorded_dispatches():
    """Patch ``models.moe._sort_assignments`` to keep, for every call, its
    ``(sorted expert ids, permutation)`` and those of ``sort_impl='xla'``
    (a stable ``torch.argsort``) on the same assignments; returns the list
    and the undo."""
    from repro_torch.models import moe
    real, seen = moe._sort_assignments, []

    def rec(flat_e, payload, impl):
        out = real(flat_e, payload, impl)
        seen.append((out, real(flat_e, payload, "xla")))
        return out
    moe._sort_assignments = rec

    def undo():
        moe._sort_assignments = real
    return seen, undo


def phase_serve(report, device):
    """Serve Granite-MoE 1B at full width through the scheduler and the
    engine with the kernels' dispatch ('pallas'), then check the admission
    permutation, the dispatch and the engine against the plain versions."""
    import numpy as np
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import plan_buckets
    from repro_torch.models import forward, init_lm
    from repro_torch.parallel.sharding import Rules
    from repro_torch.serve import BucketedScheduler, Engine, Request
    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, lm, t_init = granite_full_width(device)
    n_params = sum(p.numel() for p in lm.parameters())
    print(f"[serve] {cfg.name}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.moe.n_experts} experts top-{cfg.moe.top_k}, "
          f"{n_params} parameters in {lm.embed.dtype}, drawn on the card in "
          f"{t_init:.2f} s")

    # 1. serve 32 requests
    engine = Engine(cfg, lm, max_seq=SERVE_MAX_SEQ, sort_impl="pallas")
    engine.generate([[1, 2, 3]], max_new=2)            # cuBLAS and caches
    times = {"prefill": [], "decode": []}
    engine._prefill = timed(engine._prefill, times["prefill"])
    engine._decode = timed(engine._decode, times["decode"])
    prompts = serve_prompts(cfg.vocab_size)
    reqs = [Request(i, p, max_new=SERVE_MAX_NEW) for i, p in enumerate(prompts)]
    sched = BucketedScheduler(engine, batch_size=SERVE_BATCH)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    results, runs = launch_counts(lambda: sched.run(reqs))
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    for kname, c in runs.items():
        report.rows[kname]["launches"] += c
    if sorted(r.request_id for r in results) != list(range(len(reqs))) \
            or any(len(r.tokens) != SERVE_MAX_NEW for r in results):
        raise AssertionError("serve: not every request was answered with "
                             f"{SERVE_MAX_NEW} tokens")
    for kname in SERVE_PATH:
        if runs[kname] == 0:
            raise AssertionError(f"serve: {kname} was never launched")
    tokens = sum(len(r.tokens) for r in results)
    bounds = plan_buckets([len(p) for p in prompts], sched.n_buckets)
    waste = BucketedScheduler.padding_stats(reqs, bounds)
    print(f"[serve] {len(results)} requests, {tokens} tokens in "
          f"{wall:.3f} s ({tokens / wall:.1f} tokens/s); bounds {bounds}; "
          f"{len(times['prefill'])} prefill batches, median "
          f"{statistics.median(times['prefill']):.2f} ms a batch; "
          f"{len(times['decode'])} decode steps, median "
          f"{statistics.median(times['decode']):.2f} ms a step; padding "
          f"waste global {waste['global_waste']:.4f} bucketed "
          f"{waste['bucketed_waste']:.4f}; max_memory_allocated {peak} B; "
          f"launches {used(runs)}")

    # 2. the admission permutation on the card against the CPU
    for n in ADMISSION_QUEUES:
        queue = admission_queue(n, seed=n)
        got, runs = launch_counts(lambda: BucketedScheduler._order_by_length(
            queue, device=device))
        want = BucketedScheduler._order_by_length(queue, device="cpu")
        for kname, c in runs.items():
            report.rows[kname]["launches"] += c
        if [r.request_id for r in got] != [r.request_id for r in want]:
            raise AssertionError(f"admission of {n}: the card's permutation "
                                 "differs from the plain versions' on the "
                                 "CPU")
        print(f"[serve] admission of {n} requests: permutation equal to the "
              f"CPU's; launches {used(runs)}")

    # 3. the dispatch: one full-width prefill batch, 'pallas' and 'xla'; the
    # kernels' permutation at every layer against the stable argsort's of
    # the same assignments, and the two forwards' logits
    rng = np.random.default_rng(1)
    batch = {"tokens": torch.from_numpy(rng.integers(
        1, cfg.vocab_size, (SERVE_BATCH, DISPATCH_SEQ))).to(device)}
    logits = {}
    for impl in ("xla", "pallas"):
        ms = []
        with torch.inference_mode():
            out, runs = launch_counts(lambda: timed(forward, ms)(
                cfg, lm, batch, Rules(), sort_impl=impl))
        if impl == "pallas":
            for kname, c in runs.items():
                report.rows[kname]["launches"] += c
        logits[impl] = out[0].float()
        print(f"[serve] prefill {SERVE_BATCH} x {DISPATCH_SEQ} with "
              f"sort_impl={impl!r}: {ms[0]:.2f} ms; launches {used(runs)}")
    seen, undo = recorded_dispatches()
    try:
        with torch.inference_mode():
            forward(cfg, lm, batch, Rules(), sort_impl="pallas")
    finally:
        undo()
    if len(seen) != cfg.n_layers:
        raise AssertionError("dispatch: expected one sort a layer")
    for layer, (got, want) in enumerate(seen):
        if not all(torch.equal(g.long(), w.long())
                   for g, w in zip(got, want)):
            raise AssertionError(f"dispatch: layer {layer}'s permutation "
                                 "differs between 'pallas' and 'xla'")
    diff = float((logits["pallas"] - logits["xla"]).abs().max())
    scale = float(logits["xla"].abs().max())
    print(f"[serve] dispatch: {cfg.n_layers} layers' permutations of "
          f"{SERVE_BATCH * DISPATCH_SEQ * cfg.moe.top_k} assignments "
          f"identical to the stable argsort's; logits max abs difference "
          f"{diff} (max |logit| {scale}, tolerance {DISPATCH_LOGIT_ATOL})")
    if not diff <= DISPATCH_LOGIT_ATOL:
        raise AssertionError("dispatch: the logits differ past the bf16 "
                             "tolerance")
    del lm, engine, logits, seen
    torch.cuda.empty_cache()

    # 4. the engine on the card against the CPU, smoke config in float32
    small = get_smoke_config(SERVE_ARCH)
    cpu_lm = init_lm(small, seed=0, device="cpu")
    prompts = [list(range(1, 1 + n)) for n in (3, 17, 9, 30)]
    want = Engine(small, cpu_lm, max_seq=64, sort_impl="pallas").generate(
        prompts, max_new=8)
    got = Engine(small, cpu_lm.to(device), max_seq=64,
                 sort_impl="pallas").generate(prompts, max_new=8)
    if got != want:
        raise AssertionError(f"engine: the card's greedy tokens {got} differ "
                             f"from the CPU's {want}")
    print(f"[serve] engine at the smoke config in float32: greedy tokens "
          f"equal on the card and the CPU")
    print(f"[serve] phase took {time.perf_counter() - t_phase:.1f} s")


def synthetic_soak_words():
    """The soak's 200 words: ``tests/test_chaos.py``'s generator."""
    import numpy as np
    rng = np.random.default_rng(0)
    alpha = list("abcdefgh")
    return ["".join(rng.choice(alpha, l)) for l in rng.integers(0, 9, 200)]


def main() -> int:
    import torch
    if sys.argv[1:2] == ["--mesh-rank"]:
        return mesh_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
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
    phase_fault_tolerance(report, device, words["DS2"], big_words)
    phase_partition_and_repairs(report, device, words["DS2"], big_words)
    phase_mesh(report, device, words["DS2"], big_words)
    phase_serve(report, device)
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
