"""The readers of the port's own spans and counters
(``repro_torch.runtime.trace``): each metric from a buffer built here,
``None`` where there is nothing to read; the program's intervals joined
with a device trace by ``h100bench.trace.reduce_events``; and, on the card,
a sort call's spans on the device trace's clock.

The card's test carries the ``gpu`` marker and skips without one; run it
on the card with

    PYTHONPATH=src python -m pytest -q -m gpu h100bench/tests/test_bench_program_trace.py
"""

from __future__ import annotations

import sys

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from h100bench import bench
from h100bench.bench import Spans
from h100bench.trace import Tracer, reduce_events
from repro_torch.runtime import trace

MS = 1_000_000


@pytest.fixture(autouse=True)
def empty_buffer():
    trace.clear()
    yield
    trace.clear()


class _Clock:
    """The trace module's clock, set by hand in ms."""

    def __init__(self):
        self.ns = 0

    def time_ns(self):
        return self.ns

    def at(self, ms):
        self.ns = int(ms * MS)

    def record(self, make, a, b):
        """Record ``make()`` (a span or a sync) from ``a`` to ``b`` ms."""
        self.at(a)
        with trace.recording(), make():
            self.at(b)

    def span(self, name, a, b, **attrs):
        self.record(lambda: trace.span(name, **attrs), a, b)

    def sync(self, site, a, b):
        self.record(lambda: trace.sync(site), a, b)


@pytest.fixture
def clock(monkeypatch):
    c = _Clock()
    monkeypatch.setattr(trace, "time", c)
    return c


def _records(**counts):
    return {"trace": {"counts": counts, "busy_s": 1.0, "window_s": 2.0,
                      "ops": {}, "gaps": []}}


def _build(clock, name):
    """A buffer for the reader ``name`` and what it should read from it."""
    if name == "host_syncs.words":
        for k in range(6):
            clock.sync("sort.compact", k, k + 0.5)
        clock.span("sort.bucket", 10, 20)
        return _records(calls=2), 3.0
    if name == "host_syncs.serve":
        for k in range(8):
            clock.sync("engine.readback", k, k + 0.5)
        return _records(waves=2, prefills=8, decodes=96), 4.0
    if name == "ingest_wait_ms":
        clock.span("ingest.wait", 0, 1)
        clock.span("ingest.chunk_sort", 1, 9, chunk=0)
        clock.span("ingest.wait", 9, 12)
        return _records(calls=2), 2.0
    clock.span("serve.batch", 0, 30, requests=[1, 2])
    for a, ms in ((0, 1), (2, 5), (8, 2)):
        clock.span("engine.decode", a, a + ms, step=a)
    return _records(waves=1, prefills=4, decodes=3), 2.0


READERS = ["host_syncs.words", "ingest_wait_ms", "decode_enqueue_ms",
           "host_syncs.serve"]


@pytest.mark.parametrize("name", READERS)
def test_each_reader_reads_the_buffer(clock, name):
    records, want = _build(clock, name)
    assert bench.load_metric(name)(records) == pytest.approx(want)


@pytest.mark.parametrize("name", READERS)
def test_each_reader_reads_none_without_a_trace_or_a_span(clock, name):
    read = bench.load_metric(name)
    records, _ = _build(clock, name)
    assert read({"trace": None}) is None
    assert read({"calls": 5}) is None
    trace.clear()
    assert read(records) is None
    # spans, but none the reader looks for: a count of none is 0
    clock.span("t.other", 0, 5)
    if name.startswith("host_syncs"):
        assert read(records) == 0
    else:
        assert read(records) is None


@pytest.mark.parametrize("name", READERS)
def test_each_reader_reads_none_from_a_port_without_spans(clock, monkeypatch,
                                                          name):
    """A checkout whose port has no ``runtime.trace`` (an earlier commit):
    nothing to read, and no error."""
    import repro_torch.runtime
    records, _ = _build(clock, name)
    monkeypatch.delattr(repro_torch.runtime, "trace")
    monkeypatch.setitem(sys.modules, "repro_torch.runtime.trace", None)
    assert bench.load_metric(name)(records) is None


def test_the_manifest_reports_them_where_they_read():
    man = bench.manifest()
    by = {m["name"]: m for m in man["per_layer"]}
    assert by["host_syncs.words"]["workloads"] == ["ds2x8-oneshot",
                                                   "ds2x16-chunked"]
    assert by["ingest_wait_ms"]["workloads"] == ["ds2x16-chunked"]
    assert by["decode_enqueue_ms"]["workloads"] == ["granite-long-prompt"]
    assert by["host_syncs.serve"]["workloads"] == ["granite-long-prompt"]
    for name in READERS:
        assert by[name]["source"] in ("program_span", "program_counter")
    assert man["per_layer"][-4:] == [by[n] for n in READERS]


def test_idle_gaps_are_labelled_by_the_innermost_program_span(clock):
    """Device work at 0-10, 20-30 and 50-60 ms: the gap at 10-20 lies in a
    chunk sort's compaction, the gap at 30-50 in the wait for the worker
    after the chunk sort."""
    with trace.recording():
        clock.at(0)
        with trace.span("ingest.chunk_sort", chunk=0):
            clock.at(1)
            with trace.span("sort.bucket"):
                clock.at(9)
            with trace.span("sort.compact"):
                clock.at(19)
                with trace.sync("sort.compact"):
                    clock.at(24)
                clock.at(25)
            clock.at(30)
        with trace.span("ingest.wait"):
            clock.at(50)
    events = [("k", 0, 10 * MS), ("k", 20 * MS, 30 * MS),
              ("k", 50 * MS, 60 * MS)]
    out = reduce_events(events, 0, 60 * MS, spans=trace.intervals())
    assert out["busy_s"] == pytest.approx(0.030)
    assert [(label, round(s, 6)) for label, s in out["gaps"]] == [
        ("ingest.wait", 0.020), ("sort.compact", 0.010)]
    # beside the benchmark's own span over the whole call, put after the
    # program's: the program's innermost span keeps each gap
    out = reduce_events(events, 0, 60 * MS,
                        spans=trace.intervals() + [("sort call", 0, 60 * MS)])
    assert [label for label, _ in out["gaps"]] == ["ingest.wait",
                                                   "sort.compact"]


# ---------------- on the card ----------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_a_sort_calls_spans_lie_on_the_device_trace(cuda, monkeypatch):
    """Under the benchmark's CUDA-only profiler, the device events as its
    ``Tracer`` aligns them to the host's clock: the first distribute (B3)
    starts after ``sort.size`` opens, the second after ``sort.bucket``
    opens, and the call's last kernel ends before the overflow check's
    sync returns, since that sync waits for it all.

    A profiler session runs first: ``Tracer`` takes its marker kernel's
    start for the host's clock, and the first kernel after the process's
    first profiler start can start milliseconds late, which ``Tracer``
    would read as a clock offset."""
    import h100bench.trace as htrace
    from h100bench.traffic import words
    from repro_torch.core.bucketing import sorted_packed
    seen = {}
    reduce = htrace.reduce_events

    def capture(events, start_ns, end_ns, spans=()):
        seen["events"] = sorted((a, b, n) for n, a, b in events
                                if start_ns <= a)
        return reduce(events, start_ns, end_ns, spans)

    monkeypatch.setattr(htrace, "reduce_events", capture)
    keys, _ = words.corpus(230_000, 2**31 + 11, 0)
    sorted_packed(keys, return_packed=True, device=cuda)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]):
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    trace.clear()
    tracer = Tracer(1, Spans(True))
    tracer.start()
    sorted_packed(keys, return_packed=True, device=cuda)
    tracer.stop()
    events = seen["events"]
    by = {}
    for s in trace.spans():
        by.setdefault(s["name"], []).append(s)
    assert set(by) >= {"sync.sort.upload", "sort.size", "sort.bucket",
                       "sort.compact", "sort.pack",
                       "sync.sort.overflow_check"}
    assert trace.counters()["host_syncs"] == 5
    b3 = [a for a, _, n in events if "distribute" in n]
    info = (tracer.clock_offset_ns, len(events),
            [(a, n[:40]) for a, _, n in events[:6]],
            {k: (v[0]["start_ns"], v[0]["end_ns"]) for k, v in by.items()})
    assert len(b3) == 2, info
    assert b3[0] >= by["sort.size"][0]["start_ns"], info
    assert b3[1] >= by["sort.bucket"][0]["start_ns"], info
    last_end = max(b for _, b, _ in events)
    assert last_end <= by["sync.sort.overflow_check"][0]["end_ns"], info
