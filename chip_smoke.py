#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout, on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It imports nothing of ``jax`` or ``repro``. Phases, each fatal on failure:

  1. build — compile the four CUDA kernels from ``src/repro_torch/kernels/
     csrc`` with ``nvcc`` for ``sm_90a`` and print ``-Xptxas -v``'s
     registers, shared memory and spills per kernel;
  2. kernels — run every kernel at the shapes the main path gives it, on
     the main path's data and on adversarial inputs (sentinel-colliding
     uint32, duplicate-heavy, float32 NaN/±0/±inf with a payload lane),
     require its bits to equal its plain PyTorch version's on the card and
     its output to be sorted (a chain of stable ``torch.sort`` passes is the
     independent check), and time kernel, plain version and library call;
  3. main path — sort a 500-word chunk (OETS tier), a 3,000-word chunk
     (bitonic tier) and the paper's DS1 and DS2 (blocksort: bitonic + merge)
     through ``bucketed_sort_words`` and ``sorted_packed``, with every launch
     counter set to 0 just before and read just after; each result must
     equal Python's shortlex ``sorted``, DS1's packed lanes must equal the
     plain path's on the CPU, and all four counters must be non-zero.

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
    """Per-kernel numbers for the final JSON line."""

    def __init__(self):
        self.rows = {}

    def add(self, kernel, err: int, **numbers):
        row = self.rows.setdefault(kernel.name, {
            "name": kernel.name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{kernel.source}",
            "replaces": kernel.replaces, "launches": 0, "max_abs_err": 0})
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
    """Kernel over distinct fresh copies (in place), plain version, library."""
    import torch
    copies = [x.clone() for _ in range(min(KERNEL_ITERS, 8))]
    ms = cuda_time(lambda i: wrapper(copies[i % len(copies)].copy_(x),
                                     codes, **kw), KERNEL_ITERS)
    copy_ms = cuda_time(lambda i: copies[i % len(copies)].copy_(x),
                        KERNEL_ITERS)
    plain_ms = cuda_time(lambda i: plain(x, codes, **kw), PLAIN_ITERS, 1)
    library_ms = cuda_time(lambda i: lib(x), KERNEL_ITERS)
    return {"ms": ms - copy_ms, "plain_ms": plain_ms,
            "library_ms": library_ms}


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
               plain_ms=cuda_time(
                   lambda i: distribute_kernel.distribute_rows_plain(keys, n),
                   PLAIN_ITERS, 1),
               library_ms=None,
               **bound(n * 4 * 4 + 2 * n * 4 + 17 * 4, n * 4))
    for name, row in report.rows.items():
        print(f"[kernels] {name}: " + ", ".join(
            f"{key} {row[key]}" for key in ("shape", "ms", "plain_ms",
                                            "library_ms", "bound_ms",
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
        if count == 0:
            raise AssertionError(f"{name} was never launched on the main "
                                 "path")


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
    phase_main_path(report, device, list(words.items()))
    print(f"[done] all phases passed in {time.perf_counter() - t0:.1f} s")
    print(nvidia_smi())
    print(json.dumps({"kernels": list(report.rows.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
