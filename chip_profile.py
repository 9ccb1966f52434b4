#!/usr/bin/env python3
"""Where the time of the port's main path goes, on the card.

Run from the root of a checkout, on a machine with an NVIDIA card:

    python3 chip_profile.py

For the paper's DS1 and DS2 (``configs/paper_sort.py``) it prints:

  * the host-clock split of ``bucketed_sort_words``: packing on the host,
    ``sorted_packed`` on the card (ended by a synchronize), unpacking on the
    host — medians of 5 runs after 2 warm-up runs;
  * a ``torch.profiler`` trace of 3 ``sorted_packed`` calls: device time by
    kernel, the device's busy time (the union of its kernel, copy and set
    intervals) and its idle share of the traced window.

It exits non-zero without a card. Nothing of ``jax`` or ``repro`` is
imported.
"""

from __future__ import annotations

import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from chip_smoke import nvidia_smi  # noqa: E402  (beside this script)

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


def profile(name, words, device):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
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

    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(TRACED):
            device_part()
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
    print(f"[trace] {name}: {TRACED} sorted_packed calls, window "
          f"{wall_us / TRACED:.1f} us per call, device busy "
          f"{busy / TRACED:.1f} us per call, idle share "
          f"{1 - busy / wall_us:.4f}")
    for kname, (t, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0]):
        print(f"[trace] {name}:   {t / TRACED:10.1f} us/call "
              f"{n // TRACED:4d} x/call  {kname[:100]}")


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
    for cfg in (DS1, DS2):
        profile(cfg.name, synthetic_words(cfg.n_words, seed=cfg.seed),
                device)
    print(nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
