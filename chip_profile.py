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
    kernel against the 'take' tier and against the tournament, and
    ``merge_sorted_lex`` with the merge-path kernel against the 'packed'
    tier, over merges of 2, 8, 57, 64, 256 and 1,024 runs of 1,024 to
    1,048,576 words in all (medians of 3 host-clock calls ended by a
    synchronize, after one warm call);
  * a trace of one ``chunked_sort_words`` of DS2 at chunk 4096 with each
    merge engine, read as above.

With the argument ``partition`` it prints only the device time of
``partition_rows`` (B7) at its kernel-table shape, by CUDA function
(``partition_cost``); the wrapper's signature is the same in every version
of the port, so the script, copied into an older checkout, measures that
checkout's B7 the same way:

    python3 chip_profile.py partition

With the argument ``kernels`` it prints, the same way, only the device time
of B1 at the OETS tier's shape, of B2 at DS2's local blocks and at the run
tier's chunk blocks, of B3 on DS2's words, of B4 at one DS2 round, of
B5's split and merge at DS2's last tournament round and of B6 and its
k-way split at DS2's 57 runs, then the host time of B3, of B5's split and
front end and of B6's split and front end (``kernel_cost``):

    python3 chip_profile.py kernels

With the argument ``chunked`` it times only the million-word chunked sort
of that phase (``chunked_cost``), whose single timed call per run spreads
wider than the changes of a kernel PR:

    python3 chip_profile.py chunked

With the argument ``crossover`` it prints only the crossover of the run
merges (``crossover``), whose rows set ``ops.choose_kway_engine``'s rule:

    python3 chip_profile.py crossover

With the argument ``runtier`` it prints only the traces of DS2 chunked
with each merge engine (device busy time, idle share, device events):

    python3 chip_profile.py runtier

With the argument ``mesh`` it prints only the traces of DS2 through the
mesh tier's chunked sort at 8 destinations of this card
(``distributed_chunked_sort_lex``), with each combine engine (device busy
time, idle share, device events):

    python3 chip_profile.py mesh

With the argument ``e2e`` it runs only the end-to-end phase of
``chip_smoke.py`` (phase 3: the main path on the 500- and 3,000-word
chunks, DS1 and DS2, then the run tier's chunked sorts), whose lines give
the end-to-end times; the script, copied into an older checkout, runs that
checkout's phase the same way:

    python3 chip_profile.py e2e

With the argument ``serve`` it builds Granite-MoE 1B — or, with
``--arch``, another token arch — at its published width
(``chip_smoke.full_width``) and traces one prefill batch of 8 x 512 tokens
and then 16 decode steps of the engine with the kernels' dispatch
(``sort_impl='pallas'``): for each, the device's busy time, idle share and
top device ops by time, the device events and the port's kernel launches a
decode step, and the host microseconds a decode step takes to return
(before its synchronize) beside its whole time (``serve_cost``):

    python3 chip_profile.py serve
    python3 chip_profile.py serve --arch minicpm3-4b

With the argument ``train`` it builds Granite-MoE 1B — or, with
``--arch``, another arch — at its published width and traces one train
step of ``chip_smoke.py``'s phase 8 (8 x 512 tokens, remat from the
config, the dispatch on the kernels) after two untraced ones: the host
milliseconds a step takes to return beside its whole time, the port's
kernel launches a step, and the trace's busy time, idle share, device
events and top device ops; then the same step untraced with each remat
mode ('dots', 'full', 'none'), its host and whole time and peak memory
(``train_cost``):

    python3 chip_profile.py train

With the argument ``wave`` it runs only the serving phases of
``chip_smoke.py`` (phase 6: Granite-MoE 1B at its published width serving
a wave of requests and prefilling with each dispatch; phase 7: MiniCPM3-4B
and Zamba2-1.2B serving the wave, deepseek-v2 cut to 3 layers, the smoke
archs card against CPU), whose lines give the prefill and decode medians
and tokens/s; the script, copied into an older checkout, runs that
checkout's phases the same way:

    python3 chip_profile.py wave

It exits non-zero without a card. Nothing of ``jax`` or ``repro`` is
imported.
"""

from __future__ import annotations

import itertools
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
    context with the stream read from a ``torch.cuda.Stream`` object; then
    of the distribute kernel (B3) at DS2's 230,000 words through its
    wrapper and through its C entry point alone."""
    import torch
    from repro_torch.kernels import distribute_kernel, lex, merge_kernel
    x = torch.zeros((4, 1, 8192), dtype=torch.int32, device=device)
    codes = [lex.U32] * 4
    kernel = merge_kernel.KERNEL
    args = (x.data_ptr(), 4, 1, 8192, 0, 1, 4096, lex.codes_mask(codes))
    merge_kernel.merge_adjacent_lex(x, codes, block=4096)
    stream = torch.cuda.current_stream(device).cuda_stream

    def through_stream_object():
        with torch.cuda.device(device):
            kernel._fn(*args, torch.cuda.current_stream(device).cuda_stream)

    # B3 at DS2's word count: the wrapper (one allocation, three views),
    # and its C entry point alone (the scratch's memset and the launch)
    words = torch.zeros((230_000, 4), dtype=torch.int32, device=device)
    at, scratch = distribute_kernel.buffer_layout(230_000, 17)
    buf = torch.empty(at + scratch, dtype=torch.int32, device=device)
    b = buf.data_ptr()
    b3_args = (words.data_ptr(), 4, 230_000, 230_000, 17, b, b + 4 * 230_000,
               b + 8 * 230_000, b + 4 * at, 4 * scratch)
    distribute_kernel.distribute_rows(words)

    for name, fn in (
            ("merge_adjacent_lex", lambda: merge_kernel.merge_adjacent_lex(
                x, codes, block=4096)),
            ("Kernel.__call__", lambda: kernel(device, *args)),
            ("the C entry point through ctypes", lambda: kernel._fn(
                *args, stream)),
            ("ctypes in a device context, stream from a Stream object",
             through_stream_object),
            ("distribute_rows (230000, 4)",
             lambda: distribute_kernel.distribute_rows(words)),
            ("distribute_rows' C entry point through ctypes",
             lambda: distribute_kernel.KERNEL._fn(*b3_args, stream))):
        print(f"[launch] {name}: {host_us(fn):.2f} us per call (host clock, "
              "2000 calls)")


def crossover(device):
    """The k-way engines over merge sizes and run counts: ``merge_runs_lex``
    with the k-way kernel (B6 and its split) against the 'take' tier and
    against the tournament (ceil(log2 k) rounds of ``merge_sorted_lex``, B5
    past two blocks, as ``pipeline.merge_runs(engine='tournament')`` runs
    them), and at k = 2 ``merge_sorted_lex`` with the merge-path kernel
    against the 'packed' tier; medians of 3 host-clock calls ended by a
    synchronize, after one warm call."""
    import torch
    from repro_torch.core import packing
    from repro_torch.data import synthetic_words
    from repro_torch.kernels import ops
    keys = packing.pack_words(synthetic_words(1 << 20, seed=1))

    def tournament(ext, n_cmp):
        while len(ext) > 1:
            nxt = [ops.merge_sorted_lex(ext[i], ext[i + 1], n_cmp=n_cmp)
                   for i in range(0, len(ext) - 1, 2)]
            if len(ext) % 2:
                nxt.append(ext[-1])
            ext = nxt
        return ext[0]

    for total in (1 << 10, 1 << 12, 1 << 14, 1 << 16, 1 << 18, 1 << 20):
        for k in (2, 8, 57, 64, 256, 1024):
            if total // k < 16:
                continue
            ext, n_cmp = ext_runs(keys[:total], device, chunk=-(-total // k))
            row = {}
            for engine in ("take", "kernel", "tournament"):
                def call():
                    if engine == "tournament":
                        tournament(ext, n_cmp)
                    else:
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
            print(f"[crossover] total {total}, k {len(ext)}: " + ", ".join(
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


def device_ms_by_name(fn, calls=20, tries=2):
    """Device milliseconds per call of ``fn()`` by event name: every device
    event of ``calls`` calls in a ``torch.profiler`` window after a warm
    call (the kernels, and the memsets and fills of their wrappers). A
    window in which the profiler saw no device event (it happens now and
    then to a window in a process that has traced others) is traced again,
    up to ``tries`` windows."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    fn()
    torch.cuda.synchronize()
    by_name = {}
    for _ in range(tries):
        with torch.profiler.profile(activities=[
                ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                by_name[e.name] = (by_name.get(e.name, 0.0)
                                   + e.time_range.elapsed_us() / calls / 1e3)
        if by_name:
            break
    return by_name


def kernel_cost(device):
    """Device time per call of B1 at the 500-word chunk's buckets (4, 17,
    128), of B2 at DS2's local blocks (4, 204, 4096), at the run tier's
    chunk blocks (4, 136, 512) and at the bitonic tier's 3,000-word chunk
    (4, 17, 1024), B3 on DS2's packed words (230,000, 4) and on the run
    tier's first chunk of them (4096, 4), B4 at one DS2 round (4, 17,
    49,152), block 4096, B5's split and merge at DS2's last tournament
    round (10 arrays of 230,000, 5 compare lanes, block 256), and B6 and
    its k-way split at DS2's 57 runs (the torch split in a checkout
    without ``kway_starts``), each through its wrapper (the sorts on fresh
    copies of the same input), by device event name
    (:func:`device_ms_by_name`); then the host time per call of B3, of B5's
    split and front end (``merge_runs_lex_kernel``) and of B6's split and
    front end (``merge_runs_kway_kernel``). The wrappers' signatures are
    the same in every version of the port, so the script, copied into an
    older checkout, measures that checkout's kernels the same way."""
    import torch
    from chip_smoke import stacked_buckets
    from repro_torch import to_device
    from repro_torch.configs import DS2
    from repro_torch.core import packing
    from repro_torch.core.blocksort import default_block_size
    from repro_torch.data import synthetic_words
    from repro_torch.kernels import (bitonic_kernel, distribute_kernel,
                                     kway_kernel, lex, merge_kernel,
                                     oets_kernel, runmerge_kernel)
    u4 = [lex.U32] * 4
    keys = packing.pack_words(synthetic_words(DS2.n_words, seed=0))
    sizes = {}

    def blocks(cap):
        sizes["block"] = default_block_size(cap, n_arrays=4)
        return -(-cap // sizes["block"]) * sizes["block"]

    x = stacked_buckets(keys, device, blocks)
    block = sizes["block"]
    local = x.view(4, -1, block)
    run = stacked_buckets(keys[:4096], device, lambda cap: 4096).view(
        4, -1, default_block_size(4096, n_arrays=4))
    merged = bitonic_kernel.bitonic_rows_lex(local.clone(), u4).view(
        4, x.shape[1], -1)
    npairs = merged.shape[2] // (2 * block)
    merged = merged[:, :, :npairs * 2 * block].contiguous()
    words = lex.as_bits(to_device(keys, device)).contiguous()
    chunk = words[:4096]
    tier = stacked_buckets(packing.pack_words(synthetic_words(3000, seed=0)),
                           device, lambda cap: 1 << (cap - 1).bit_length())
    oets = stacked_buckets(packing.pack_words(synthetic_words(500, seed=0)),
                           device, lambda cap: 128)
    # B5: the merge of runs [0, 32) against runs [32, 57) of DS2 chunked at
    # 4096, each side merged first
    ext, n_cmp = ext_runs(keys, device)
    half = 1 << ((len(ext) - 1).bit_length() - 1)
    run_a = kway_kernel.merge_runs_kway_take(ext[:half], n_cmp=n_cmp)
    run_b = kway_kernel.merge_runs_kway_take(ext[half:], n_cmp=n_cmp)
    blk = runmerge_kernel.DEFAULT_MERGE_BLOCK
    operands = runmerge_kernel.merge_operands(run_a, run_b, n_cmp, block=blk)

    def split():
        return runmerge_kernel.merge_path_starts(run_a[:n_cmp],
                                                 run_b[:n_cmp], blk)

    # B6 and its split at DS2's 57 runs: the device split where the
    # checkout has one (kway_starts), else the torch split it replaces
    kblk = kway_kernel.DEFAULT_KWAY_BLOCK
    kway_ops = kway_kernel.kway_operands(ext, n_cmp, block=kblk)
    ns = [r[0].shape[0] for r in ext]
    if hasattr(kway_kernel, "kway_starts"):
        kway_split_label = "B6 split kway_starts"

        def kway_split():
            return kway_kernel.kway_starts(kway_ops[0], ns, kway_ops[3],
                                           kblk)
    else:
        kway_split_label = "B6 split, torch: kway_cursors(kway_ranks)"

        def kway_split():
            return kway_kernel.kway_cursors(kway_kernel.kway_ranks(
                [r[:n_cmp] for r in ext]), kblk)

    def kway_front_end():
        return kway_kernel.merge_runs_kway_kernel(ext, n_cmp=n_cmp)

    def front_end():
        return runmerge_kernel.merge_runs_lex_kernel(run_a, run_b,
                                                     n_cmp=n_cmp)

    def on_copies(x, call):
        """``call`` on one of four copies of ``x``, refreshed each time:
        the sorts and the merge work in place."""
        copies, turn = [x.clone() for _ in range(4)], itertools.count()
        return lambda: call(copies[next(turn) % 4].copy_(x))

    cases = (
        ("B1 oets_rows_lex", oets, on_copies(
            oets, lambda t: oets_kernel.oets_rows_lex(t, u4))),
        ("B2 bitonic_rows_lex", local, on_copies(
            local, lambda t: bitonic_kernel.bitonic_rows_lex(t, u4))),
        ("B2 bitonic_rows_lex", run, on_copies(
            run, lambda t: bitonic_kernel.bitonic_rows_lex(t, u4))),
        ("B2 bitonic_rows_lex", tier, on_copies(
            tier, lambda t: bitonic_kernel.bitonic_rows_lex(t, u4))),
        ("B3 distribute_rows", words,
         lambda: distribute_kernel.distribute_rows(words)),
        ("B3 distribute_rows", chunk,
         lambda: distribute_kernel.distribute_rows(chunk)),
        ("B4 merge_adjacent_lex", merged, on_copies(
            merged, lambda t: merge_kernel.merge_adjacent_lex(
                t, u4, block=block))),
        ("B5 split merge_path_starts", operands[0], split),
        ("B5 merge runmerge", operands[2],
         lambda: runmerge_kernel.runmerge(*operands, blk)),
        ("B6 merge kway_merge", kway_ops[1],
         lambda: kway_kernel.kway_merge(*kway_ops, kblk)),
        (kway_split_label, kway_ops[0], kway_split),
    )
    for label, t, fn in cases:
        by_name = device_ms_by_name(fn)
        kernel = {n: ms for n, ms in by_name.items()
                  if "copy" not in n.lower() and "elementwise" not in n}
        print(f"[kernels] {label} {tuple(t.shape)}: device "
              f"{sum(kernel.values()):.5f} ms per call without the copies "
              f"of the input, {sum(by_name.values()):.5f} in all; "
              + ", ".join(
                  f"{name[:60]} {ms:.5f}"
                  for name, ms in sorted(by_name.items())))
    # B3's `ms` is the host's: its wrapper's host time per call
    print(f"[kernels] B3 distribute_rows {tuple(words.shape)}: host "
          f"{host_us(lambda: distribute_kernel.distribute_rows(words)):.2f} "
          "us per call (host clock, 2000 calls)")
    # B5's split and front end, where the host's time per call is the cost
    for label, fn in (("B5 split merge_path_starts", split),
                      ("B5 front end merge_runs_lex_kernel", front_end),
                      (kway_split_label, kway_split),
                      ("B6 front end merge_runs_kway_kernel",
                       kway_front_end)):
        print(f"[kernels] {label}: host {host_us(fn, calls=200, warmup=5):.2f}"
              " us per call (host clock, 200 calls); "
              f"{median_ms(lambda: (fn(), torch.cuda.synchronize())):.4f} ms "
              "per call ended by a synchronize (median of 5)")


def chunked_cost(device, calls=5):
    """Host-clock milliseconds of ``calls`` calls of ``chunked_sort_packed``
    on the million-word corpus at chunk 16,384 with ``validate='full'``
    (``chip_smoke.py``'s run-tier case), each ended by a synchronize, after
    a warm call; its signature is the same in every version of the port."""
    import torch
    from repro_torch.core import packing
    from repro_torch.data import synthetic_words
    from repro_torch.pipeline import chunked_sort_packed
    keys = packing.pack_words(synthetic_words(1_048_576, seed=0))

    def call():
        chunked_sort_packed(keys, chunk_size=16384, validate="full",
                            device=device)
        torch.cuda.synchronize()

    call()
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        call()
        times.append((time.perf_counter() - t0) * 1e3)
    print("[chunked] 1M words chunked, k-way, validate=full: "
          + ", ".join(f"{t:.1f}" for t in times) + f" ms; median "
          f"{statistics.median(times):.1f} ms over {calls} calls")


def profile_run_tier(words, device):
    from repro_torch.pipeline import chunked_sort_words
    for engine in ("auto", "tournament"):
        def call():
            chunked_sort_words(words, chunk_size=4096, merge_engine=engine,
                               device=device)
        call()
        trace(f"DS2 chunked, merge_engine={engine}", call, 1)


def profile_mesh(words, device, dests=8):
    """A trace of one ``distributed_chunked_sort_lex`` of ``words`` at
    ``dests`` destinations of this card, with each combine engine."""
    from repro_torch.core import packing
    from repro_torch.core.distributed import distributed_chunked_sort_lex
    keys = packing.pack_words(words)
    for engine in ("auto", "tournament"):
        def call():
            distributed_chunked_sort_lex(keys, devices=[device] * dests,
                                         merge_engine=engine)
        call()
        trace(f"DS2 at {dests} destinations, merge_engine={engine}", call, 1)


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


def serve_cost(device, arch: str, steps: int = 16):
    """The serving path's trace: one full-width prefill batch of ``arch``,
    then ``steps`` decode steps."""
    import torch
    from chip_smoke import (DISPATCH_SEQ, SERVE_BATCH, SERVE_MAX_SEQ,
                            full_width, launch_counts, used)
    from repro_torch.models import init_cache
    from repro_torch.serve import Engine
    from repro_torch.serve.engine import _pad_cache_to
    cfg, lm, _ = full_width(device, arch)
    engine = Engine(cfg, lm, max_seq=SERVE_MAX_SEQ, sort_impl="pallas")
    engine.generate([[1, 2, 3]], max_new=2)              # warm
    gen = torch.Generator(device=device).manual_seed(0)
    tokens = torch.randint(1, cfg.vocab_size, (SERVE_BATCH, DISPATCH_SEQ),
                           generator=gen, device=device)
    mask = torch.ones_like(tokens, dtype=torch.int32)
    with torch.inference_mode():
        trace(f"serve {cfg.name} prefill {SERVE_BATCH} x {DISPATCH_SEQ}",
              lambda: engine._prefill(tokens, mask), 1)
        logits, cache = engine._prefill(tokens, mask)
        axes = init_cache(cfg, SERVE_BATCH, DISPATCH_SEQ, abstract=True)[1]
        cache = _pad_cache_to(cache, axes, SERVE_MAX_SEQ)
        state = {"tok": logits[:, -1].argmax(-1)[:, None],
                 "cur": torch.full((SERVE_BATCH,), DISPATCH_SEQ,
                                   dtype=torch.int32, device=device)}
        host, whole = [], []

        def step():
            t0 = time.perf_counter()
            lg, _ = engine._decode(cache, state["tok"], state["cur"])
            t1 = time.perf_counter()
            state["tok"] = lg.argmax(-1)[:, None]
            state["cur"] = state["cur"] + 1
            torch.cuda.synchronize()
            host.append((t1 - t0) * 1e6)
            whole.append((time.perf_counter() - t0) * 1e6)

        _, runs = launch_counts(step)
        for _ in range(steps):
            step()
        host, whole = host[1:], whole[1:]
        print(f"[serve] decode, not traced: host {statistics.median(host):.1f}"
              f" us a step to return, {statistics.median(whole):.1f} us a "
              f"step with its synchronize (medians of {steps}); the port's "
              f"kernel launches a step {used(runs)}")
        trace(f"serve {cfg.name} decode step (batch {SERVE_BATCH})", step,
              steps)


def train_cost(device, arch: str):
    """One traced train step of ``arch`` at full width (``chip_smoke``'s
    phase-8 batch of 8 x 512 and hyperparameters, the dispatch on the
    kernels), after two untraced steps: the host's time to return a step,
    its kernel launches, and the trace."""
    import torch
    from chip_smoke import (TRAIN_BATCH, TRAIN_HYPER, TRAIN_SEQ, full_width,
                            launch_counts, train_batch, used)
    from repro_torch.optim import init_opt_state
    from repro_torch.parallel.sharding import Rules
    from repro_torch.training import Hyper, make_train_step
    cfg, lm, _ = full_width(device, arch)
    opt = init_opt_state(lm)
    step_fn = make_train_step(cfg, Rules(), Hyper(**TRAIN_HYPER))
    batch = train_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, device)
    state = {"lm": lm, "opt": opt, "step": 0, "host": [], "whole": []}

    def step():
        t0 = time.perf_counter()
        state["lm"], state["opt"], _ = step_fn(state["lm"], state["opt"],
                                               batch, state["step"])
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        state["step"] += 1
        state["host"].append((t1 - t0) * 1e3)
        state["whole"].append((time.perf_counter() - t0) * 1e3)

    step()                                               # warm
    _, runs = launch_counts(step)
    print(f"[train] {cfg.name} step of {TRAIN_BATCH} x {TRAIN_SEQ}, not "
          f"traced: host {state['host'][-1]:.2f} ms to return, "
          f"{state['whole'][-1]:.2f} ms with its synchronize; the port's "
          f"kernel launches a step {used(runs)}")
    trace(f"train {cfg.name} step ({TRAIN_BATCH} x {TRAIN_SEQ})", step, 1)
    # the same step with each remat mode, untraced: what the recompute and
    # the selective policy's per-op dispatch cost the host and the device
    for remat in ("dots", "full", "none"):
        step_fn = make_train_step(cfg.replace(remat=remat), Rules(),
                                  Hyper(**TRAIN_HYPER))
        step()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(2):
            step()
        print(f"[train] remat={remat!r}: host {state['host'][-1]:.2f} ms to "
              f"return, {state['whole'][-1]:.2f} ms with its synchronize; "
              f"max_memory_allocated {torch.cuda.max_memory_allocated()} B")


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
    if sys.argv[1:] == ["kernels"]:
        kernel_cost(device)
        print(nvidia_smi())
        return 0
    if sys.argv[1:] == ["chunked"]:
        chunked_cost(device)
        print(nvidia_smi())
        return 0
    if sys.argv[1:] == ["crossover"]:
        crossover(device)
        print(nvidia_smi())
        return 0
    if sys.argv[1:] == ["runtier"]:
        profile_run_tier(synthetic_words(DS2.n_words, seed=DS2.seed), device)
        print(nvidia_smi())
        return 0
    if sys.argv[1:] == ["mesh"]:
        profile_mesh(synthetic_words(DS2.n_words, seed=DS2.seed), device)
        print(nvidia_smi())
        return 0
    if sys.argv[1:2] == ["serve"]:
        from chip_smoke import SERVE_ARCH
        args = sys.argv[2:]
        serve_cost(device, args[1] if args[:1] == ["--arch"] else SERVE_ARCH)
        print(nvidia_smi())
        return 0
    if sys.argv[1:2] == ["train"]:
        from chip_smoke import TRAIN_ARCH
        args = sys.argv[2:]
        train_cost(device, args[1] if args[:1] == ["--arch"] else TRAIN_ARCH)
        print(nvidia_smi())
        return 0
    if sys.argv[1:] == ["wave"]:
        from chip_smoke import Report, phase_families, phase_serve
        phase_serve(Report(), device)
        phase_families(Report(), device)
        print(nvidia_smi())
        return 0
    if sys.argv[1:] == ["e2e"]:
        from chip_smoke import Report, phase_main_path, phase_run_tier
        words = {name: synthetic_words(n, seed=0) for name, n in (
            ("chunk-500", 500), ("chunk-3000", 3000),
            ("DS1", DS1.n_words), ("DS2", DS2.n_words))}
        report = Report()
        phase_main_path(report, device, list(words.items()))
        phase_run_tier(report, device, words["DS2"],
                       synthetic_words(1_048_576, seed=0))
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
