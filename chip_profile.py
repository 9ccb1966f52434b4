#!/usr/bin/env python3
"""Where the time of the port's main path goes, on the card.

Run from the root of a checkout, on a machine with an NVIDIA card:

    python3 chip_profile.py

First it prints the host time of one launch of the merge kernel, layer
by layer (``launch_cost``). Then, for the paper's DS1 and DS2
(``configs/paper_sort.py``), it prints:

  * the host-clock split of ``bucketed_sort_words``: packing on the host,
    ``sorted_packed`` on the card (ended by a synchronize), unpacking on the
    host — medians of 5 runs after 2 warm-up runs;
  * a ``torch.profiler`` trace of 3 ``sorted_packed`` calls: device time by
    kernel, the device's busy time (the union of its kernel, copy and set
    intervals) and its idle share of the traced window.

For the run tier it prints:

  * the crossover of the run merges: ``merge_runs_lex`` with the k-way
    kernel against the 'take' tier, and ``merge_sorted_lex`` with the
    merge-path kernel against the 'packed' tier, over merges of 2, 8 and
    64 runs of 1,024 to 262,144 words in all (medians of 3 host-clock
    calls ended by a synchronize, after one warm call);
  * a trace of one ``chunked_sort_words`` of DS2 at chunk 4096 with each
    merge engine, read as above.

With the argument ``partition`` it prints only the device time of
``partition_rows`` (B7) at its kernel-table shape, by CUDA function
(``partition_cost``); the wrapper's signature is the same in every version
of the port, so the script, copied into an older checkout, measures that
checkout's B7 the same way:

    python3 chip_profile.py partition

It exits non-zero without a card. Nothing of ``jax`` or ``repro`` is
imported.
"""

from __future__ import annotations

import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from chip_smoke import ext_runs, nvidia_smi, quantiles  # noqa: E402  (beside this script)

RUNS = 5
TRACED = 3


def median_ms(fn, runs=RUNS, warmup=2):
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e3


def busy_us(events) -> float:
    """Length of the union of the device intervals of ``events``."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    total, end = 0.0, float("-inf")
    for a, b in spans:
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def trace(name, fn, calls):
    """Trace ``calls`` calls of ``fn`` (each ended by a synchronize) and
    print the window, the device's busy time and idle share, and device
    time by kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
            torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev_events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev_events:
        print(f"[trace] {name}: the profiler saw no device activity; device "
              "busy time and idle share not measured")
        return
    by_name = {}
    for e in dev_events:
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), n + 1)
    busy = busy_us(dev_events)
    print(f"[trace] {name}: {calls} call(s), window "
          f"{wall_us / calls:.1f} us per call, device busy "
          f"{busy / calls:.1f} us per call, idle share "
          f"{1 - busy / wall_us:.4f}, {len(dev_events) // calls} device "
          "events per call")
    for kname, (t, n) in sorted(by_name.items(),
                                key=lambda kv: -kv[1][0])[:12]:
        print(f"[trace] {name}:   {t / calls:10.1f} us/call "
              f"{n // calls:6d} x/call  {kname[:100]}")


def host_us(fn, calls=2000, warmup=50) -> float:
    """Host microseconds per call of ``fn`` over ``calls`` calls, the
    device drained before and after."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def launch_cost(device):
    """Host time per launch of the merge kernel (B4) on one 8192-wide window
    of four lanes, a few microseconds of device time, so the host sets the
    pace: through the wrapper, through ``Kernel.__call__``, the C entry
    point alone through ctypes, and the same ctypes call inside a device
    context with the stream read from a ``torch.cuda.Stream`` object."""
    import torch
    from repro_torch.kernels import lex, merge_kernel
    x = torch.zeros((4, 1, 8192), dtype=torch.int32, device=device)
    codes = [lex.U32] * 4
    kernel = merge_kernel.KERNEL
    args = (x.data_ptr(), 4, 1, 8192, 0, 1, 4096, lex.codes_mask(codes))
    merge_kernel.merge_adjacent_lex(x, codes, block=4096)
    stream = torch.cuda.current_stream(device).cuda_stream

    def through_stream_object():
        with torch.cuda.device(device):
            kernel._fn(*args, torch.cuda.current_stream(device).cuda_stream)

    for name, fn in (
            ("merge_adjacent_lex", lambda: merge_kernel.merge_adjacent_lex(
                x, codes, block=4096)),
            ("Kernel.__call__", lambda: kernel(device, *args)),
            ("the C entry point through ctypes", lambda: kernel._fn(
                *args, stream)),
            ("ctypes in a device context, stream from a Stream object",
             through_stream_object)):
        print(f"[launch] {name}: {host_us(fn):.2f} us per call (host clock, "
              "2000 calls)")


def crossover(device):
    """Kernel engines against the torch tiers over merge sizes and k."""
    import torch
    from repro_torch.core import packing
    from repro_torch.data import synthetic_words
    from repro_torch.kernels import ops
    keys = packing.pack_words(synthetic_words(1 << 18, seed=1))
    for total in (1 << 10, 1 << 12, 1 << 14, 1 << 16, 1 << 18):
        for k in (2, 8, 64):
            if total // k < 16:
                continue
            ext, n_cmp = ext_runs(keys[:total], device, chunk=total // k)
            row = {}
            for engine in ("take", "kernel"):
                def call():
                    ops.merge_runs_lex(ext, engine=engine, n_cmp=n_cmp)
                    torch.cuda.synchronize()
                row[f"kway {engine}"] = median_ms(call, runs=3, warmup=1)
            if k == 2:
                for engine in ("packed", "kernel"):
                    def call():
                        ops.merge_sorted_lex(*ext, engine=engine,
                                             n_cmp=n_cmp)
                        torch.cuda.synchronize()
                    row[f"pair {engine}"] = median_ms(call, runs=3, warmup=1)
            print(f"[crossover] total {total}, k {k}: " + ", ".join(
                f"{name} {ms:.3f} ms" for name, ms in row.items()))


def partition_cost(device, calls=20):
    """Device time per call of ``partition_rows`` (B7) on the million-word
    corpus's first packed lane as (64, 16,384), with 7 and 127 splitters
    at its quantiles: every device event of ``calls`` calls in a
    ``torch.profiler`` window after a warm call, in all and by name (the
    kernels, and a fill of the counts where the wrapper zeroes them)."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from repro_torch import to_device
    from repro_torch.core import packing
    from repro_torch.data import synthetic_words
    from repro_torch.kernels import partition_kernel
    lane = packing.pack_words(synthetic_words(1_048_576, seed=0))[:, 0]
    x = to_device(lane.view(np.int32).reshape(64, -1), device)
    for n_spl in (7, 127):
        s = quantiles(x, n_spl)
        partition_kernel.partition_rows(x, s)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[
                ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                partition_kernel.partition_rows(x, s)
            torch.cuda.synchronize()
        by_name = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                by_name[e.name] = (by_name.get(e.name, 0.0)
                                   + e.time_range.elapsed_us() / calls / 1e3)
        print(f"[partition] {tuple(x.shape)}, {n_spl} splitters: device "
              f"{sum(by_name.values()):.5f} ms per call over {calls} calls; "
              + ", ".join(f"{name[:60]} {ms:.5f}"
                          for name, ms in sorted(by_name.items())))


def profile_run_tier(words, device):
    from repro_torch.pipeline import chunked_sort_words
    for engine in ("auto", "tournament"):
        def call():
            chunked_sort_words(words, chunk_size=4096, merge_engine=engine,
                               device=device)
        call()
        trace(f"DS2 chunked, merge_engine={engine}", call, 1)


def profile(name, words, device):
    import torch
    from repro_torch import sorted_packed, to_numpy
    from repro_torch.core import packing

    keys = packing.pack_words(words)

    def device_part():
        sorted_packed(keys, return_packed=True, device=device)
        torch.cuda.synchronize()

    sorted_keys = sorted_packed(keys, device=device)[1]
    pack_ms = median_ms(lambda: packing.pack_words(words))
    dev_ms = median_ms(device_part)
    unpack_ms = median_ms(lambda: packing.unpack_words(to_numpy(sorted_keys)))
    print(f"[host] {name}: {len(words)} words; pack_words {pack_ms:.3f} ms, "
          f"sorted_packed {dev_ms:.3f} ms, to_numpy+unpack_words "
          f"{unpack_ms:.3f} ms (medians of {RUNS})")

    trace(f"{name} sorted_packed", device_part, TRACED)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs import DS1, DS2
    from repro_torch.data import synthetic_words
    from repro_torch.kernels import _build
    _build.build_all()
    device = torch.device("cuda")
    if sys.argv[1:] == ["partition"]:
        partition_cost(device)
        print(nvidia_smi())
        return 0
    launch_cost(device)
    for cfg in (DS1, DS2):
        profile(cfg.name, synthetic_words(cfg.n_words, seed=cfg.seed),
                device)
    crossover(device)
    profile_run_tier(synthetic_words(DS2.n_words, seed=DS2.seed), device)
    print(nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
