"""The port's own spans and counters: where a call's host time goes.

    from repro_torch.runtime import trace

    with trace.recording():
        sorted_packed(keys, device="cuda")
    trace.spans(), trace.counters(), trace.intervals()
    trace.clear()

``span(name, **attrs)`` times one stage of the program; names read
``<layer>.<stage>``, and ``attrs`` carry what ties the span to its work (a
chunk index, a decode step, a batch's request ids). ``sync(site)`` is a
span named ``"sync." + site`` around a point where the host waits for the
device (a readback, a boolean-mask index of a device tensor, a blocking
upload from pageable memory); it adds one to the counters ``host_syncs``
and ``host_syncs.<site>``. A site counts where it would wait on a card,
whatever device the call runs on, so a CPU run counts what a card's would.
``count(name, n)`` adds to a plain counter.

Recording is on while a :func:`recording` block is open, or while a torch
profiler runs (``torch.autograd.profiler._is_profiler_enabled``, the flag
torch keeps for such checks): a traced window of ``h100bench`` records the
program's spans of exactly its traced units. Off, :func:`span` and
:func:`sync` return one shared object that does nothing, after one flag
test: no allocation, no clock read, no lock.

Spans are kept in memory, in the order they open, and nothing is written
out. Each holds the thread that opened it and its parent, the innermost
span open on that thread (a stack a thread: the ingest worker's spans nest
among themselves, not under the sort the main thread runs meanwhile).

The clock is ``time.time_ns()``, the clock of ``h100bench``'s own spans,
to which ``h100bench.trace.Tracer`` aligns the device trace with its marker
kernel: a program span lies over the device's idle gaps as it is.
:func:`intervals` gives the spans in the form
``h100bench.trace.reduce_events(spans=...)`` takes.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager

from torch.autograd import profiler as _profiler

__all__ = ["span", "sync", "count", "recording", "spans", "counters",
           "intervals", "clear"]

_lock = threading.Lock()
_local = threading.local()
_recording = 0          # open recording() blocks
_spans: list = []       # _Span records, in the order they opened
_counters: dict = {}


class _Off:
    """What :func:`span` and :func:`sync` return while nothing records."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


class _Span:
    __slots__ = ("name", "attrs", "start_ns", "end_ns", "parent", "thread")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs
        self.start_ns = self.end_ns = self.parent = self.thread = None

    def __enter__(self):
        stack = _stack()
        self.parent = stack[-1] if stack else None
        self.thread = threading.get_ident()
        stack.append(self)
        _spans.append(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.time_ns()
        _stack().pop()
        return False


def span(name: str, **attrs):
    """A context manager that records ``name`` from entry to exit."""
    if not (_recording or _profiler._is_profiler_enabled):
        return _OFF
    return _Span(name, attrs)


def sync(site: str):
    """:func:`span` ``"sync." + site`` around one wait of the host for the
    device, counted in ``host_syncs`` and ``host_syncs.<site>``."""
    if not (_recording or _profiler._is_profiler_enabled):
        return _OFF
    with _lock:
        for key in ("host_syncs", "host_syncs." + site):
            _counters[key] = _counters.get(key, 0) + 1
    return _Span("sync." + site, {})


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while recording."""
    if _recording or _profiler._is_profiler_enabled:
        with _lock:
            _counters[name] = _counters.get(name, 0) + n


@contextmanager
def recording():
    """Record while the block is open (blocks nest)."""
    global _recording
    with _lock:
        _recording += 1
    try:
        yield
    finally:
        with _lock:
            _recording -= 1


def spans() -> list:
    """Every span recorded, in the order they opened: dicts of ``name``,
    ``start_ns``, ``end_ns`` (``None`` while open), ``parent`` (its index
    in this list, ``None`` at a thread's top or where :func:`clear` dropped
    it), ``thread`` and ``attrs``."""
    recs = list(_spans)
    index = {id(r): i for i, r in enumerate(recs)}
    return [{"name": r.name, "start_ns": r.start_ns, "end_ns": r.end_ns,
             "parent": None if r.parent is None else index.get(id(r.parent)),
             "thread": r.thread, "attrs": dict(r.attrs)} for r in recs]


def counters() -> dict:
    with _lock:
        return dict(_counters)


def intervals() -> list:
    """``(name, start_ns, end_ns)`` of every closed span, the latest to open
    first, so that of nested spans the innermost comes first: the first of
    equal covers is the label ``h100bench.trace.reduce_events`` keeps."""
    closed = [(r.name, r.start_ns, r.end_ns, _depth(r))
              for r in list(_spans) if r.end_ns is not None]
    closed.sort(key=lambda s: (-s[1], -s[3]))
    return [s[:3] for s in closed]


def _depth(r) -> int:
    d = 0
    while r.parent is not None:
        r, d = r.parent, d + 1
    return d


def clear() -> None:
    """Drop every span and counter recorded so far."""
    with _lock:
        _spans.clear()
        _counters.clear()
