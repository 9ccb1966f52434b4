"""The device trace of a window and its reduction: the device's busy time
(the union of every kernel, copy and memset interval), device time by
kernel function, and the idle gaps labelled by the benchmark's own host
span that covers them.

The method is ``chip_profile.py``'s (``busy_us``: the union of the device
intervals; the idle share is one less busy over the window), copied here
so that a later change of the program cannot move the yardstick.
``torch.profiler`` traces the card through CUPTI; host operators are not
recorded, so the trace stays small over a window of many launches.
"""

from __future__ import annotations

import re
import time

# a kernel's function name from its demangled signature:
# "void ns::name<4, 2>(unsigned int*, ...)" -> "name"; names such as
# "Memcpy HtoD (Pageable -> Device)" stay whole
_SIGNATURE = re.compile(r"^(?:void\s+)?([\w:]+)[<(]")


def function_name(name: str) -> str:
    m = _SIGNATURE.match(name.strip())
    return m.group(1).split("::")[-1] if m else name


def merge_intervals(spans):
    """Sorted, disjoint unions of ``(start, end)`` pairs."""
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


def reduce_events(events, start_ns: int, end_ns: int, spans=()) -> dict:
    """``events``: ``(name, start_ns, end_ns)`` of device activity;
    ``spans``: ``(label, start_ns, end_ns)`` host spans. Returns the busy
    seconds inside ``[start_ns, end_ns]``, the window's seconds, device
    seconds and counts by function, and every idle gap as ``(label,
    seconds)``, longest first."""
    inside = [(n, max(a, start_ns), min(b, end_ns)) for n, a, b in events
              if b > start_ns and a < end_ns]
    ops: dict = {}
    for n, a, b in inside:
        fn = function_name(n)
        t, c = ops.get(fn, (0.0, 0))
        ops[fn] = (t + (b - a) * 1e-9, c + 1)
    busy = merge_intervals((a, b) for _, a, b in inside)
    busy_s = sum(b - a for a, b in busy) * 1e-9
    gaps, cursor = [], start_ns
    for a, b in busy + [[end_ns, end_ns]]:
        if a > cursor:
            gaps.append((cursor, a))
        cursor = max(cursor, b)
    labelled = [(_label(spans, a, b), (b - a) * 1e-9) for a, b in gaps]
    labelled.sort(key=lambda g: -g[1])
    return {"busy_s": busy_s, "window_s": (end_ns - start_ns) * 1e-9,
            "ops": ops, "gaps": labelled, "events": len(inside)}


def _label(spans, a: int, b: int) -> str:
    """The host span that overlaps ``[a, b]`` most; the innermost (latest
    to start) among equals."""
    best, best_cover = "untracked host work", 0
    for label, s, e in spans:
        cover = min(b, e) - max(a, s)
        if cover > best_cover or (cover == best_cover > 0 and s >= a):
            best, best_cover = label, cover
    return best


class Tracer:
    """``torch.profiler`` over the first ``units`` units of a window
    (:class:`h100bench.bench.Window` starts and stops it). ``result`` holds
    :func:`reduce_events`' dict once stopped, or ``None`` where the
    profiler saw no device activity."""

    def __init__(self, units: int, spans):
        self.units = units
        self.spans = spans
        self.result = None
        self._prof = None
        self._t0 = self._t1 = None
        self.clock_offset_ns = 0

    def start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        # a marker kernel to align the trace's clock with the host's
        self._marker_ns = time.time_ns()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        self._t0 = time.time_ns()

    def stop(self):
        if self._prof is None or self._t1 is not None:
            return
        import torch
        torch.cuda.synchronize()
        self._t1 = time.time_ns()
        self._prof.__exit__(None, None, None)
        self.result = self._reduce()

    def _reduce(self):
        from torch.autograd import DeviceType
        events = [(e.name(), e.start_ns(), e.end_ns())
                  for e in self._prof.profiler.kineto_results.events()
                  if e.device_type() == DeviceType.CUDA]
        marker = [a for n, a, _ in events if "spin_kernel" in n
                  or "sleep" in n.lower()]
        if marker and abs(marker[0] - self._marker_ns) > 1_000_000:
            # a trace on another clock: move it onto the host's
            self.clock_offset_ns = marker[0] - self._marker_ns
            events = [(n, a - self.clock_offset_ns, b - self.clock_offset_ns)
                      for n, a, b in events]
        if not events:
            return None
        return reduce_events(events, self._t0, self._t1, self.spans.items)
