"""The port's spans and host-sync counter (``repro_torch.runtime.trace``)
on the CPU: off, nothing records and a span allocates nothing; under
``recording()`` and under a torch profiler the sort, the chunked ingest and
a served model record their spans, parents and syncs, and every output is
the same bit for bit as with tracing off."""

import sys
import threading
import tracemalloc
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_smoke_config
from repro_torch.core.bucketing import sorted_packed
from repro_torch.models import init_lm
from repro_torch.pipeline.ingest import chunked_sort_packed
from repro_torch.runtime import trace
from repro_torch.serve import BucketedScheduler, Engine, Request


@pytest.fixture(autouse=True)
def empty_buffer():
    trace.clear()
    yield
    trace.clear()


def _keys(n, seed=0, lanes=2):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 1 << 32, (n, lanes), dtype=np.uint64)
    keys[rng.random(n) < 0.3, 1] = 0          # shorter words too
    return keys.astype(np.uint32)


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, (tuple, list)):
            _same(x, y)
        else:
            assert x.dtype == y.dtype and torch.equal(x, y)


def _loop(n):
    for i in range(n):
        with trace.span("a.b", chunk=i):
            pass
        with trace.sync("a.c"):
            pass
        trace.count("a.d")


def test_off_records_nothing_and_allocates_nothing():
    assert trace.span("x") is trace.span("y", chunk=3) is trace.sync("z")
    out = sorted_packed(_keys(300), return_packed=True, device="cpu")
    _loop(10)
    assert out[0].shape[0] == 300
    assert trace.spans() == [] and trace.counters() == {}
    assert trace.intervals() == []
    _loop(100)
    tracemalloc.start()
    try:
        start, _ = tracemalloc.get_traced_memory()
        tracemalloc.reset_peak()
        _loop(5000)
        now, peak = tracemalloc.get_traced_memory()
        # the same loop recording keeps every span: tens of bytes each
        with trace.recording():
            _loop(500)
        on, _ = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    assert now == start and peak - start < 4096
    assert on - now > 500 * 50


def test_sorted_packed_records_its_stages_and_syncs():
    keys = _keys(2000, seed=1)
    off = sorted_packed(keys, return_packed=True, device="cpu")
    with trace.recording():
        on = sorted_packed(keys, return_packed=True, device="cpu")
    _same(off, on)
    names = [s["name"] for s in trace.spans()]
    assert names == ["sync.sort.upload", "sort.size", "sync.sort.size",
                     "sort.bucket", "sort.compact", "sync.sort.compact",
                     "sync.sort.compact", "sort.pack",
                     "sync.sort.overflow_check"]
    # the largest bucket's 1,365 words sort in 3 blocks of 512: blocksort
    # merges them in 2 rounds
    assert trace.counters() == {
        "host_syncs": 5, "host_syncs.sort.upload": 1,
        "host_syncs.sort.size": 1, "host_syncs.sort.compact": 2,
        "host_syncs.sort.overflow_check": 1, "blocksort.rounds": 2}
    spans = trace.spans()
    for s in spans:
        assert s["start_ns"] <= s["end_ns"]
        if s["parent"] is not None:
            p = spans[s["parent"]]
            assert p["start_ns"] <= s["start_ns"] and s["end_ns"] <= p["end_ns"]
    assert spans[2]["parent"] == 1 and spans[5]["parent"] == 4
    # keys already on the device are not uploaded
    trace.clear()
    with trace.recording():
        sorted_packed(torch.from_numpy(keys.view(np.int32)).view(torch.uint32),
                      capacity=2000, device="cpu")
    assert "host_syncs.sort.upload" not in trace.counters()
    assert trace.counters()["host_syncs"] == 3


def test_chunked_sort_records_chunks_waits_stages_and_merge():
    keys = _keys(3000, seed=2)
    off = chunked_sort_packed(keys, chunk_size=1000, device="cpu")
    with trace.recording():
        on = chunked_sort_packed(keys, chunk_size=1000, device="cpu")
    _same((off.lengths, off.keys), (on.lengths, on.keys))
    spans = trace.spans()
    main = threading.get_ident()
    by = Counter(s["name"] for s in spans)
    assert by["ingest.chunk_sort"] == 3 and by["ingest.merge"] == 1
    assert by["ingest.wait"] == 3 and by["ingest.stage"] == 3
    assert by["merge.kway"] == 1 and by["sort.bucket"] == 3
    assert [s["attrs"]["chunk"] for s in spans
            if s["name"] == "ingest.chunk_sort"] == [0, 1, 2]
    stages = [s for s in spans if s["name"] == "ingest.stage"]
    assert sorted(s["attrs"]["chunk"] for s in stages) == [0, 1, 2]
    for s in stages:
        assert s["thread"] != main
        assert s["parent"] is None or spans[s["parent"]]["thread"] == s["thread"]
    for s in spans:
        if s["parent"] is not None:
            assert spans[s["parent"]]["thread"] == s["thread"]
        if s["name"] in ("ingest.chunk_sort", "ingest.wait", "ingest.merge"):
            assert s["thread"] == main and s["parent"] is None
        if s["name"] == "sort.bucket":
            assert spans[s["parent"]]["name"] == "ingest.chunk_sort"
        if s["name"] == "merge.kway":
            assert spans[s["parent"]]["name"] == "ingest.merge"
            assert s["attrs"]["runs"] == 3
    # a chunk sort at the chunk's capacity: the compaction's two mask
    # indexes and the overflow check, and no upload (the chunk is staged)
    assert trace.counters() == {"host_syncs": 9,
                                "host_syncs.sort.compact": 6,
                                "host_syncs.sort.overflow_check": 3}


def test_a_torch_profiler_switches_recording_on():
    """The switch reads torch's own flag, set while any profiler runs; a
    torch without it fails here rather than recording nothing."""
    from torch.autograd import profiler
    assert profiler._is_profiler_enabled is False
    with profile(activities=[ProfilerActivity.CPU]):
        assert profiler._is_profiler_enabled is True
        out = sorted_packed(_keys(500, seed=3), device="cpu")
        with trace.span("t.inside", k=1):
            pass
    with trace.span("t.after"):
        pass
    names = [s["name"] for s in trace.spans()]
    assert "sort.bucket" in names and names[-1] == "t.inside"
    assert trace.spans()[-1]["attrs"] == {"k": 1}
    assert trace.counters()["host_syncs"] == 5
    _same(out, sorted_packed(_keys(500, seed=3), device="cpu"))


def test_recording_nests_and_intervals_put_the_innermost_first():
    with trace.recording():
        with trace.recording():
            with trace.span("o.outer"):
                with trace.span("o.inner"):
                    with trace.sync("o.wait"):
                        pass
        with trace.span("o.open"):
            names = [n for n, _, _ in trace.intervals()]
            assert names == ["sync.o.wait", "o.inner", "o.outer"]
    with trace.span("o.off"):
        pass
    assert [s["name"] for s in trace.spans()] == [
        "o.outer", "o.inner", "sync.o.wait", "o.open"]
    assert [s["parent"] for s in trace.spans()] == [None, 0, 1, None]
    assert trace.counters() == {"host_syncs": 1, "host_syncs.o.wait": 1}


def test_threads_keep_their_own_stacks_and_lose_no_count():
    """More threads than cores, switching every microsecond: every count
    lands, and every span's parent is on its own thread."""
    n_threads, n = 16, 300
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(k):
            for i in range(n):
                with trace.span("t.outer", k=k):
                    with trace.sync("t.site"):
                        trace.count("t.count", 2)
        with trace.recording():
            threads = [threading.Thread(target=work, args=(k,))
                       for k in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    c = trace.counters()
    assert c["host_syncs"] == c["host_syncs.t.site"] == n_threads * n
    assert c["t.count"] == 2 * n_threads * n
    spans = trace.spans()
    assert len(spans) == 2 * n_threads * n
    for s in spans:
        if s["name"] == "sync.t.site":
            p = spans[s["parent"]]
            assert p["name"] == "t.outer" and p["thread"] == s["thread"]
        else:
            assert s["parent"] is None


@pytest.fixture(scope="module")
def served():
    cfg = get_smoke_config("granite-moe-1b-a400m")
    return cfg, init_lm(cfg, seed=0, device="cpu")


def test_a_served_model_records_batches_steps_and_syncs(served):
    cfg, lm = served
    rng = np.random.default_rng(4)
    max_new = 4
    reqs = [Request(i, [int(t) for t in rng.integers(1, cfg.vocab_size, n)],
                    max_new) for i, n in enumerate((3, 5, 9, 12, 7, 4))]

    def run():
        eng = Engine(cfg, lm, max_seq=64, sort_impl="pallas")
        sched = BucketedScheduler(eng, batch_size=2, bounds=[6, 64])
        return sched.run(reqs)

    off = run()
    with trace.recording():
        on = run()
    assert [(r.request_id, r.tokens) for r in on] == \
        [(r.request_id, r.tokens) for r in off]
    spans = trace.spans()
    batches = [i for i, s in enumerate(spans) if s["name"] == "serve.batch"]
    assert sorted(r for i in batches
                  for r in spans[i]["attrs"]["requests"]) == \
        list(range(len(reqs)))
    admissions = [s for s in spans if s["name"] == "serve.admission"]
    assert [(s["attrs"]["bucket"], s["attrs"]["n"]) for s in admissions] \
        == [(0, 3), (1, 3)]

    def batch_of(s):
        while s["parent"] is not None:
            s = spans[s["parent"]]
        return s

    for i in batches:
        kids = [s for s in spans if s["parent"] == i]
        names = [s["name"] for s in kids]
        assert names.count("engine.prefill") == 1
        assert [s["attrs"]["step"] for s in kids
                if s["name"] == "engine.decode"] == list(range(1, max_new))
        assert names.count("sync.engine.upload") == 4
        assert names.count("sync.engine.readback") == max_new
        assert names.count("engine.cache_grow") == 1
        prefill = next(j for j, s in enumerate(spans)
                       if s["parent"] == i and s["name"] == "engine.prefill")
        assert [s["name"] for s in spans if s["parent"] == prefill].count(
            "sync.model.positions") == 1
    # one a MoE layer (every layer past the dense ones) a forward pass
    moe = [s for s in spans if s["name"] == "moe.dispatch"]
    n_moe = cfg.n_layers - cfg.moe.first_dense
    assert len(moe) == n_moe * len(batches) * max_new
    assert all(batch_of(s)["name"] == "serve.batch" for s in moe)
    assert all(spans[s["parent"]]["name"] in ("engine.prefill",
                                              "engine.decode") for s in moe)
    # by hand: each admission of 3 uploads 3 lanes and reads back once;
    # each batch uploads 4 tensors and the prefill's position offset, and
    # reads back one token a step
    want = 2 * (3 + 1) + len(batches) * (4 + 1 + max_new)
    c = trace.counters()
    assert c["host_syncs"] == want == len(
        [s for s in spans if s["name"].startswith("sync.")])
    assert c["host_syncs.serve.admission_upload"] == 6
    assert c["host_syncs.serve.admission_readback"] == 2
    assert c["host_syncs.engine.readback"] == len(batches) * max_new
