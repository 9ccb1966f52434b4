"""The port's sort supervisor (``repro_torch.runtime.sortfault``) and the
fault-tolerant chunked sort (``store=``, ``supervisor=``), against the
reference's (``repro.runtime``, ``repro.pipeline``): the supervisor half of
``tests/test_failure.py`` and the chunked half of ``tests/test_sortfault.py``
on the CPU (the kernels' plain versions). Every injected failure recovers
to output bit-identical to the reference's and to Python's shortlex
``sorted``; a resume sorts only the chunks the store lacks; and a store
written by either package resumes in the other with zero chunk sorts.

Sizes stay small (chunks of 64, words of at most 8 bytes); the reference
sorts with ``algorithm='xla'``."""

import json
import os
import shutil
import threading
import time
from unittest import mock

import numpy as np
import pytest
import torch

import repro.pipeline.ingest as ref_ingest
import repro_torch.pipeline.ingest as ingest_mod
import repro_torch.runtime as port_runtime
from repro import runtime as ref_runtime
from repro.core.packing import pack_words
from repro.pipeline import RunStore as RefRunStore
from repro.pipeline import chunked_sort_packed as ref_chunked_packed
from repro.pipeline import chunked_sort_words as ref_chunked_words
from repro_torch.checkpoint import CorruptSnapshotError
from repro_torch.interop import to_numpy
from repro_torch.pipeline import (RunStore, ValidationError,
                                  chunked_sort_packed, chunked_sort_words,
                                  merge_runs, sorted_run)
from repro_torch.runtime import (CapacityOverflow, DeviceFailure,
                                 ProcessKilled, RetryPolicy, SortSupervisor,
                                 SpeculationMismatch, SpeculationPolicy,
                                 StageFailure, StageFailureInjector,
                                 StageTimeout, StragglerMonitor)
from repro_torch.runtime.sortfault import KNOWN_STAGES

_ENGINES = ("auto", "kway", "kway_kernel", "tournament")


def _words(n, seed, max_len=8):
    rng = np.random.default_rng(seed)
    alpha = list("abcdefgh")
    return ["".join(rng.choice(alpha, l))
            for l in rng.integers(0, max_len + 1, n)]


def _shortlex(words):
    return sorted(words, key=lambda w: (len(w.encode()), w.encode()))


def _sup(inj=None, retries=3, **kw):
    return SortSupervisor(policy=RetryPolicy(max_retries=retries),
                          injector=inj, **kw)


def _port(words, **kw):
    return chunked_sort_words(words, chunk_size=64, device="cpu", **kw)


def _ref(words, **kw):
    return ref_chunked_words(words, chunk_size=64, algorithm="xla", **kw)


class _Sorts:
    """Counts the port's chunk sorts (``ingest.sorted_run`` calls)."""

    def __init__(self):
        self.n = 0

    def __enter__(self):
        real = ingest_mod.sorted_run

        def counting(keys, **kw):
            self.n += 1
            return real(keys, **kw)
        self._patch = mock.patch.object(ingest_mod, "sorted_run", counting)
        self._patch.start()
        return self

    def __exit__(self, *exc):
        self._patch.stop()


# ---------------------------------------------------------------------------
# the supervisor, against the reference's on Python callables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 42, (1 << 64) - 1])
@pytest.mark.parametrize("jitter", [0.0, 0.5, 1.0])
def test_retry_jitter_schedule_is_the_references(seed, jitter):
    kw = dict(max_retries=5, backoff_base=0.5, backoff_factor=3.0,
              jitter=jitter, seed=seed)
    port, ref = RetryPolicy(**kw), ref_runtime.RetryPolicy(**kw)
    for stream in (0, 1, 7, 1 << 40, (1 << 64) - 1):
        for attempt in range(1, 6):
            assert port.delay(attempt, stream=stream) == \
                ref.delay(attempt, stream=stream)


def test_retry_jitter_schedule_pinned():
    p = RetryPolicy(max_retries=3, backoff_base=0.5, jitter=1.0, seed=42)
    assert [p.delay(a, stream=0) for a in (1, 2, 3)] == pytest.approx(
        [0.13591061335532129, 0.7866412375473091, 1.8628382167494537])
    assert [p.delay(a, stream=1) for a in (1, 2, 3)] == pytest.approx(
        [0.20080581975595135, 0.027594869490522256, 0.20276720752981037])
    legacy = RetryPolicy(backoff_base=0.5)
    assert [legacy.delay(a, stream=9) for a in (1, 2, 3)] == [0.5, 1.0, 2.0]


def _delays(pkg):
    inj = pkg.StageFailureInjector(
        fail_at={"streaming_combine": {0, 2}, "ingest_chunk": {1}})
    delays = []
    sup = pkg.SortSupervisor(
        policy=pkg.RetryPolicy(max_retries=3, backoff_base=0.5, jitter=1.0,
                               seed=11),
        injector=inj, sleep=delays.append)
    for stage, v in (("streaming_combine", 1), ("ingest_chunk", 2),
                     ("ingest_chunk", 3), ("streaming_combine", 4)):
        assert sup.run_stage(stage, lambda v=v: v) == v
    return delays, [(e.stage, e.attempt, e.action, e.detail)
                    for e in sup.events], inj.fired


def test_supervisor_retries_as_the_reference():
    """Per-stage jitter streams (crc32 of the stage, the call count): the
    port's sleeps, events and fired faults are the reference's."""
    got = _delays(port_runtime)
    assert got == _delays(ref_runtime)
    assert len(got[0]) == 3 and len(set(got[0])) == 3


def test_injector_fires_once_per_scheduled_occurrence():
    def drive(pkg):
        inj = pkg.StageFailureInjector(
            fail_at={"ingest_chunk": {0, 2}},
            device_fail_at={"exchange": {1}}, failed_devices=3,
            timeout_at={"merge_round": {0}}, kill_at={"run_exchange": {1}},
            slow_at={"streaming_combine": {1: 0.25}})
        seen = []
        for stage in ("ingest_chunk",) * 4 + ("exchange",) * 3 + (
                "merge_round",) * 2 + ("run_exchange",) * 3 + (
                "streaming_combine",) * 2:
            try:
                seen.append(inj.check(stage))
            except Exception as e:           # noqa: BLE001 — recorded
                seen.append(type(e).__name__)
        return seen, inj.fired, inj.occurrences

    got = drive(port_runtime)
    assert got == drive(ref_runtime)
    assert got[1] == [("ingest_chunk", 0, "transient"),
                      ("ingest_chunk", 2, "transient"),
                      ("exchange", 1, "device"),
                      ("merge_round", 0, "timeout"),
                      ("run_exchange", 1, "kill"),
                      ("streaming_combine", 1, "slow")]
    assert KNOWN_STAGES == ref_runtime.sortfault.KNOWN_STAGES


def test_run_stage_exhausts_retries_and_backs_off():
    inj = StageFailureInjector(fail_at={"ingest_chunk": {0, 1, 2, 3, 4}})
    sup = SortSupervisor(policy=RetryPolicy(max_retries=2), injector=inj)
    with pytest.raises(StageFailure):
        sup.run_stage("ingest_chunk", lambda: "never")
    assert [e.action for e in sup.events] == ["retry", "retry"]
    inj = StageFailureInjector(fail_at={"ingest_chunk": {0, 1, 2}})
    delays = []
    sup = SortSupervisor(policy=RetryPolicy(max_retries=3, backoff_base=0.5),
                         injector=inj, sleep=delays.append)
    assert sup.run_stage("ingest_chunk", lambda: 42) == 42
    assert delays == [0.5, 1.0, 2.0]


def test_run_with_capacity_doubles_to_required():
    sup = SortSupervisor()
    attempts = []

    def fn(cap):
        attempts.append(cap)
        if cap < 40:
            raise CapacityOverflow("too small", cap, required=40)
        return cap

    assert sup.run_with_capacity("ingest_chunk", fn, 4) == 40
    assert attempts == [4, 40]
    assert [e.action for e in sup.events] == ["capacity_double"]

    def bottomless(cap):
        raise CapacityOverflow("bottomless", cap)

    with pytest.raises(CapacityOverflow, match="still overflowing"):
        sup.run_with_capacity("ingest_chunk", bottomless, 1, max_doublings=3)


def test_capacity_doubling_recovers_a_real_overflow():
    """``run_with_capacity`` around the port's chunk sort: the overflow the
    sort raises at a small capacity doubles until it fits."""
    keys = pack_words(["abcd"] * 50 + ["ab"] * 14)
    sup = SortSupervisor()
    run = sup.run_with_capacity(
        "ingest_chunk", lambda cap: sorted_run(keys, capacity=cap,
                                               device="cpu"), 4)
    assert [e.action for e in sup.events][:1] == ["capacity_double"]
    assert int(run.lengths.shape[0]) == 64


def test_run_distributed_shrinks_and_gives_up():
    inj = StageFailureInjector(device_fail_at={"exchange": {0}},
                               failed_devices=2)
    sup = SortSupervisor(injector=inj)
    meshes = []
    out = sup.run_distributed(lambda d: meshes.append(d) or f"mesh{d}",
                              8, lambda mesh: (mesh, "sorted"))
    assert out == ("mesh6", "sorted") and meshes == [6]
    assert [(e.stage, e.action, e.detail) for e in sup.events] == \
        [("exchange", "remesh", "8 -> 6 devices")]
    sup = SortSupervisor(injector=StageFailureInjector(
        device_fail_at={"exchange": {0}}, failed_devices=7))
    with pytest.raises(RuntimeError, match="insufficient surviving") as ei:
        sup.run_distributed(lambda d: d, 8, lambda m: m, min_devices=4)
    assert isinstance(ei.value.__cause__, DeviceFailure)
    sup = SortSupervisor(injector=StageFailureInjector(
        device_fail_at={"exchange": {0, 1, 2}}))
    with pytest.raises(RuntimeError, match="exceeded max recoveries"):
        sup.run_distributed(lambda d: d, 8, lambda m: m, max_recoveries=2)


def test_injected_timeout_is_retried_like_transient():
    inj = StageFailureInjector(timeout_at={"streaming_combine": {0}})
    sup = SortSupervisor(policy=RetryPolicy(max_retries=2), injector=inj)
    assert sup.run_stage("streaming_combine", lambda: "ok") == "ok"
    assert [e.action for e in sup.events] == ["timeout_retry"]
    sup2 = SortSupervisor(policy=RetryPolicy(max_retries=1),
                          injector=StageFailureInjector(
                              timeout_at={"run_exchange": {0, 1, 2}}))
    with pytest.raises(StageTimeout):
        sup2.run_stage("run_exchange", lambda: "never")


def test_deadline_converts_hang_to_timeout_and_retry_succeeds():
    inj = StageFailureInjector(slow_at={"streaming_combine": {0: 0.5}})
    sup = SortSupervisor(policy=RetryPolicy(max_retries=2), injector=inj,
                         deadlines={"streaming_combine": 0.1})
    t0 = time.monotonic()
    assert sup.run_stage("streaming_combine", lambda: "done") == "done"
    assert time.monotonic() - t0 < 0.45
    assert [e.action for e in sup.events] == ["timeout_retry"]
    assert "deadline" in sup.events[0].detail
    sup = SortSupervisor(policy=RetryPolicy(max_retries=1),
                         injector=StageFailureInjector(
                             slow_at={"run_exchange": {0: 0.3, 1: 0.3}}),
                         deadlines={"run_exchange": 0.05})
    with pytest.raises(StageTimeout) as ei:
        sup.run_stage("run_exchange", lambda: "never")
    assert ei.value.deadline == pytest.approx(0.05)


def test_stages_with_and_without_deadline_threads():
    sup = SortSupervisor(deadlines={"merge_round": 5.0})
    main = threading.get_ident()
    seen = []
    sup.run_stage("ingest_chunk", lambda: seen.append(threading.get_ident()))
    sup.run_stage("merge_round", lambda: seen.append(threading.get_ident()))
    assert seen[0] == main and seen[1] != main


def test_kill_propagates_without_retry():
    inj = StageFailureInjector(kill_at={"streaming_combine": {1}})
    sup = SortSupervisor(policy=RetryPolicy(max_retries=5), injector=inj)
    assert sup.run_stage("streaming_combine", lambda: 0) == 0
    calls = []
    with pytest.raises(ProcessKilled) as ei:
        sup.run_stage("streaming_combine", lambda: calls.append(1))
    assert ei.value.occurrence == 1 and calls == [] and sup.events == []


def _warm_monitor(mean=0.01, warmup=3):
    mon = StragglerMonitor(warmup=warmup, min_ratio=2.0)
    for s in range(warmup):
        mon.record(s, mean)
    return mon


def test_run_speculative_fast_primary_no_backup():
    mon = _warm_monitor()
    sup = SortSupervisor(
        speculation=SpeculationPolicy(monitor=mon, min_wait=0.2))
    assert sup.run_speculative("streaming_combine", lambda: "fast") == "fast"
    assert sup.events == [] and mon.count == 4


def test_run_speculative_backup_wins_and_loser_confirmed():
    inj = StageFailureInjector(slow_at={"streaming_combine": {0: 0.6}})
    sup = SortSupervisor(
        injector=inj,
        speculation=SpeculationPolicy(monitor=_warm_monitor(), min_wait=0.05))
    out = sup.run_speculative("streaming_combine", lambda: 41 + 1,
                              digest_of=lambda v: v)
    assert out == 42
    assert [e.action for e in sup.events] == ["speculate",
                                             "speculation_confirmed"]
    assert "backup won" in sup.events[-1].detail


def test_run_speculative_digest_mismatch_raises():
    inj = StageFailureInjector(slow_at={"streaming_combine": {0: 0.6}})
    sup = SortSupervisor(
        injector=inj,
        speculation=SpeculationPolicy(monitor=_warm_monitor(), min_wait=0.05))
    results = iter([1, 2])
    with pytest.raises(SpeculationMismatch):
        sup.run_speculative("streaming_combine", lambda: next(results),
                            digest_of=lambda v: v)


def test_run_speculative_loser_failure_is_recorded_not_fatal():
    sup = SortSupervisor(speculation=SpeculationPolicy(
        monitor=_warm_monitor(), min_wait=0.05))
    calls = []

    def fn():
        calls.append(1)
        if len(calls) == 1:
            time.sleep(0.4)
            raise RuntimeError("late failure")
        return "ok"

    assert sup.run_speculative("streaming_combine", fn,
                               digest_of=lambda v: v) == "ok"
    assert [e.action for e in sup.events] == ["speculate",
                                             "speculation_loser_failed"]


def test_run_speculative_retries_and_falls_back_to_run_stage():
    inj = StageFailureInjector(fail_at={"streaming_combine": {0}})
    sup = SortSupervisor(policy=RetryPolicy(max_retries=2), injector=inj,
                         speculation=SpeculationPolicy(
                             monitor=_warm_monitor(mean=0.05)))
    assert sup.run_speculative("streaming_combine", lambda: "ok") == "ok"
    assert [e.action for e in sup.events] == ["retry"]
    sup = SortSupervisor(injector=StageFailureInjector(
        fail_at={"streaming_combine": {0}}))
    assert sup.run_speculative("streaming_combine", lambda: 7) == 7
    assert [e.action for e in sup.events] == ["retry"]


# ---------------------------------------------------------------------------
# injected stage failures in the chunked sort recover bit-identically
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ds():
    """Words and the reference's chunked sort of them, computed once."""
    out = {}
    for name, (n, seed) in {"200": (200, 0), "300": (300, 1),
                            "256": (256, 3)}.items():
        words = _words(n, seed)
        out[name] = (words, _ref(words, merge_engine="kway"))
    return out


def test_chunk_sort_failure_recovers_bit_identical(ds):
    words, want = ds["200"]
    inj = StageFailureInjector(fail_at={"ingest_chunk": {0, 2}})
    sup = _sup(inj)
    assert _port(words, supervisor=sup) == want == _shortlex(words)
    assert [f[2] for f in inj.fired] == ["transient", "transient"]
    assert [e.action for e in sup.events] == ["retry", "retry"]


def test_merge_round_failure_recovers_bit_identical(ds):
    words, want = ds["300"]            # 5 runs -> 3 rounds
    inj = StageFailureInjector(fail_at={"merge_round": {0, 1}})
    sup = _sup(inj)
    assert _port(words, supervisor=sup, merge_engine="tournament",
                 validate="full") == want
    assert inj.occurrences == {"ingest_chunk": 5, "merge_round": 5}
    assert [e.stage for e in sup.events] == ["merge_round"] * 2


def test_streaming_combine_failure_recovers_bit_identical(ds):
    words, want = ds["300"]
    inj = StageFailureInjector(fail_at={"streaming_combine": {0}})
    sup = _sup(inj)
    assert _port(words, supervisor=sup, validate="full") == want
    assert ("streaming_combine", 0, "transient") in inj.fired
    assert [e.action for e in sup.events] == ["retry"]


def test_retries_exhausted_propagates_stage_failure():
    inj = StageFailureInjector(fail_at={"ingest_chunk": {0, 1, 2}})
    with pytest.raises(StageFailure):
        _port(_words(100, 2), supervisor=_sup(inj, retries=2))


def test_deadline_on_the_chunk_sort_runs_it_on_a_worker(ds):
    """A deadline moves each chunk sort onto a worker thread; the output
    stays the reference's, and a hang past the deadline is retried."""
    words, want = ds["200"]
    inj = StageFailureInjector(slow_at={"ingest_chunk": {1: 0.6}})
    sup = _sup(inj, deadlines={"ingest_chunk": 0.3,
                               "streaming_combine": 30.0})
    threads = threading.active_count()
    assert _port(words, supervisor=sup, validate="full") == want
    assert [e.action for e in sup.events] == ["timeout_retry"]
    # the abandoned sort finishes on its worker; let it, before the next
    # test counts sorts
    deadline = time.monotonic() + 30
    while threading.active_count() > threads and time.monotonic() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= threads


@pytest.mark.parametrize("engine", _ENGINES)
def test_store_and_supervisor_with_every_engine(tmp_path, ds, engine):
    """Both robustness arguments at once, with every merge engine: the
    first call, and a resume that sorts nothing — each the reference's
    output."""
    words, want = ds["300"]
    store = RunStore(str(tmp_path))
    stage = "merge_round" if engine == "tournament" else "streaming_combine"
    sup = _sup(StageFailureInjector(fail_at={"ingest_chunk": {3},
                                             stage: {0}}))
    assert _port(words, store=store, supervisor=sup, merge_engine=engine,
                 validate="full") == want
    assert [e.stage for e in sup.events] == ["ingest_chunk", stage]
    with _Sorts() as sorts:
        assert _port(words, store=RunStore(str(tmp_path)),
                     supervisor=_sup(), merge_engine=engine) == want
    assert sorts.n == 0


def test_merge_runs_takes_a_supervisor():
    runs = [sorted_run(pack_words(_words(n, n), width=8), device="cpu")
            for n in (40, 30, 20)]
    lanes = [r.lanes() for r in runs]
    for engine, stage in (("kway", "streaming_combine"),
                          ("tournament", "merge_round")):
        inj = StageFailureInjector(fail_at={stage: {0}})
        sup = _sup(inj)
        got = merge_runs(lanes, engine=engine, supervisor=sup)
        for g, w in zip(got, merge_runs(lanes, engine=engine)):
            assert torch.equal(g, w)
        assert [e.stage for e in sup.events] == [stage]


# ---------------------------------------------------------------------------
# resume from persisted runs
# ---------------------------------------------------------------------------

def test_resume_skips_completed_runs(tmp_path, ds):
    words, want = ds["256"]            # 4 chunks of 64
    store = RunStore(str(tmp_path))
    inj = StageFailureInjector(fail_at={"ingest_chunk": {2, 3, 4}})
    with pytest.raises(StageFailure):
        _port(words, store=store, supervisor=_sup(inj, retries=2))
    assert store.completed() == [0, 1]
    with _Sorts() as sorts:
        assert _port(words, store=store, validate="full") == want
    assert sorts.n == 2
    assert store.completed() == [0, 1, 2, 3]
    with _Sorts() as sorts:
        assert _port(words, store=store, validate="full",
                     merge_engine="kway") == want
    assert sorts.n == 0


def test_kill_then_resume(tmp_path, ds):
    """A simulated kill at the fourth chunk sort: the job dies holding
    three runs; the next invocation sorts only the last one."""
    words, want = ds["256"]
    store = RunStore(str(tmp_path))
    inj = StageFailureInjector(kill_at={"ingest_chunk": {3}})
    with pytest.raises(ProcessKilled):
        _port(words, store=store, supervisor=_sup(inj))
    assert store.completed() == [0, 1, 2]
    with _Sorts() as sorts:
        assert _port(words, store=RunStore(str(tmp_path))) == want
    assert sorts.n == 1


def test_damaged_store_resorts_exactly_the_lost_chunks(tmp_path, caplog):
    words = _words(64 * 6, 21)
    want = _shortlex(words)
    store = RunStore(str(tmp_path))
    assert _port(words, store=store) == want
    root = str(tmp_path)
    shutil.rmtree(os.path.join(root, "step_1"))
    os.rename(os.path.join(root, "step_3"), os.path.join(root, ".tmp_3"))
    victim = os.path.join(root, "step_4", "keys.npy")
    with open(victim, "r+b") as f:
        f.truncate(os.path.getsize(victim) // 2)
    with open(os.path.join(root, "step_5", "manifest.json"), "w") as f:
        f.write('{"step": 5, "lea')
    store = RunStore(root)
    assert not os.path.exists(os.path.join(root, ".tmp_3"))
    with _Sorts() as sorts:
        assert _port(words, store=store, validate="full") == want
    assert sorts.n == 4
    assert store.completed() == list(range(6))
    assert "chunk 4 unreadable" in caplog.text
    assert "chunk 5 manifest unreadable" in caplog.text
    with _Sorts() as sorts:
        assert _port(words, store=store) == want
    assert sorts.n == 0


def test_stale_store_recomputes(tmp_path):
    store = RunStore(str(tmp_path))
    _port(_words(128, 4), store=store)
    words = _words(128, 5)
    assert _port(words, store=store, validate="full") == _shortlex(words)
    with _Sorts() as sorts:
        assert _port(words, store=store) == _shortlex(words)
    assert sorts.n == 0


def test_short_stored_run_recomputes(tmp_path):
    """A run whose arrays lost rows consistently (manifest and leaves
    rewritten) loads but holds fewer rows than the run manifest records:
    re-sorted, not merged short."""
    words = _words(128, 9)
    store = RunStore(str(tmp_path))
    _port(words, store=store)
    step = os.path.join(str(tmp_path), "step_0")
    with open(os.path.join(step, "manifest.json")) as f:
        man = json.load(f)
    for leaf in man["leaves"]:
        arr = np.load(os.path.join(step, leaf["file"]))[:-1]
        np.save(os.path.join(step, leaf["file"]), arr)
        leaf["shape"] = list(arr.shape)
    with open(os.path.join(step, "manifest.json"), "w") as f:
        json.dump(man, f)
    with _Sorts() as sorts:
        assert _port(words, store=store) == _shortlex(words)
    assert sorts.n == 1


def test_tampered_stored_run_caught_by_validate(tmp_path):
    words = _words(128, 6)
    store = RunStore(str(tmp_path))
    _port(words, store=store)
    keys_file = os.path.join(str(tmp_path), "step_1", "keys.npy")
    keys = np.load(keys_file)
    keys[3, 0] ^= np.uint32(1 << 7)
    np.save(keys_file, keys)
    with pytest.raises(ValidationError, match="run 1"):
        _port(words, store=store, validate="full")


def test_packed_store_resume(tmp_path):
    keys = pack_words(_words(150, 17))
    store = RunStore(str(tmp_path))
    run1 = chunked_sort_packed(keys, chunk_size=64, store=store,
                               validate="full", device="cpu")
    want = ref_chunked_packed(keys, chunk_size=64, algorithm="xla")
    with _Sorts() as sorts:
        run2 = chunked_sort_packed(keys, chunk_size=64, store=store,
                                   validate="full", device="cpu")
        from_tensor = chunked_sort_packed(
            torch.from_numpy(keys.view(np.int32)).view(torch.uint32),
            chunk_size=64, store=store, device="cpu")
    assert sorts.n == 0
    for run in (run1, run2, from_tensor):
        np.testing.assert_array_equal(to_numpy(run.keys),
                                      np.asarray(want.keys))
        np.testing.assert_array_equal(to_numpy(run.lengths),
                                      np.asarray(want.lengths))


def test_store_load_defaults_to_the_card(tmp_path):
    store = RunStore(str(tmp_path))
    _port(_words(70, 8), store=store)
    lengths, keys, packed = store.load(0, device="cpu")
    assert lengths.dtype == torch.int32 and keys.dtype == torch.uint32
    assert len(packed) == 2 and packed[0].dtype == torch.uint32
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            store.load(0)


# ---------------------------------------------------------------------------
# one store, two packages
# ---------------------------------------------------------------------------

def test_reference_store_resumes_in_the_port(tmp_path, ds):
    words, want = ds["300"]
    _ref(words, store=RefRunStore(str(tmp_path)))
    with _Sorts() as sorts:
        got = _port(words, store=RunStore(str(tmp_path)), validate="full")
    assert got == want and sorts.n == 0


def test_port_store_resumes_in_the_reference(tmp_path, ds):
    words, want = ds["300"]
    _port(words, store=RunStore(str(tmp_path)))
    launches = []
    real = ref_ingest.sorted_run
    with mock.patch.object(ref_ingest, "sorted_run",
                           lambda k, **kw: launches.append(1)
                           or real(k, **kw)):
        got = _ref(words, store=RefRunStore(str(tmp_path)),
                   validate="full")
    assert got == want and launches == []


def test_both_packages_write_the_same_store(tmp_path, ds):
    """The same words sorted into a store by each package: every run's
    manifest.json lists the same leaves (names, order, dtypes, shapes) and
    the same extra, and every .npy holds the same bytes."""
    words, _ = ds["300"]
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    _ref(words, store=RefRunStore(str(ref_dir)))
    _port(words, store=RunStore(str(port_dir)))
    assert RunStore(str(port_dir)).completed() == list(range(5))
    for step in range(5):
        with open(ref_dir / f"step_{step}" / "manifest.json") as f:
            want = json.load(f)
        with open(port_dir / f"step_{step}" / "manifest.json") as f:
            got = json.load(f)
        assert got == want
        assert [e["name"] for e in got["leaves"]] == \
            ["keys", "lengths", "packed0", "packed1"]
        for leaf in want["leaves"]:
            assert (port_dir / f"step_{step}" / leaf["file"]).read_bytes() \
                == (ref_dir / f"step_{step}" / leaf["file"]).read_bytes()


def test_torn_reference_run_raises_the_ports_typed_error(tmp_path):
    words = _words(100, 12)
    _ref(words, store=RefRunStore(str(tmp_path)))
    victim = os.path.join(str(tmp_path), "step_0", "lengths.npy")
    with open(victim, "wb"):
        pass
    with pytest.raises(CorruptSnapshotError, match="zero-length"):
        RunStore(str(tmp_path)).load(0, device="cpu")
    with _Sorts() as sorts:
        assert _port(words, store=RunStore(str(tmp_path))) == \
            _shortlex(words)
    assert sorts.n == 1
