"""The port's out-of-core mesh sort (``repro_torch.core.distributed.
distributed_chunked_sort_lex``): every case of
``tests/test_distributed_chunked.py`` and the mesh cases of
``tests/test_shards.py``, in-process over CPU destinations repeated 8 (or 4)
ways — the reference's "single repeated device" path, which runs the same
code as a real mesh. Every output is held bit for bit to the reference's
on the same packed words, to the single-process chunked pipeline and to
Python's shortlex order; a ``ShardStore`` spilled by either package
resumes in the other with zero destination merges."""

import os
from unittest import mock

import jax
import numpy as np
import pytest
import torch

import repro.pipeline.merge as ref_merge_mod
import repro_torch.pipeline.ingest as ingest_mod
import repro_torch.pipeline.merge as merge_mod
from repro.core.distributed import \
    distributed_chunked_sort_lex as ref_chunked_sort
from repro.pipeline import ShardStore as RefShardStore
from repro.runtime import CapacityOverflow as RefCapacityOverflow
from repro_torch.core.distributed import distributed_chunked_sort_lex
from repro_torch.core.packing import pack_words, unpack_words
from repro_torch.interop import to_numpy
from repro_torch.pipeline import (RunStore, ShardedRun, ShardStore,
                                  chunked_sort_packed)
from repro_torch.runtime import (CapacityOverflow, ProcessKilled,
                                 RetryPolicy, SortSupervisor,
                                 SpeculationPolicy, StageFailure,
                                 StageFailureInjector, StragglerMonitor)

CPU = torch.device("cpu")
DEVS8 = [CPU] * 8
DEVS4 = [CPU] * 4


def _words(n, seed, max_len=8):
    rng = np.random.default_rng(seed)
    alpha = list("abcdefgh")
    return ["".join(rng.choice(alpha, l))
            for l in rng.integers(0, max_len + 1, n)]


WORDS = _words(509, 0)
KEYS = np.asarray(pack_words(WORDS))
SHORTLEX = sorted(WORDS, key=lambda w: (len(w.encode()), w.encode()))


def _host(run):
    """A run's ``(lengths, keys)`` as numpy — either package's."""
    if isinstance(run.lengths, torch.Tensor):
        return to_numpy(run.lengths), to_numpy(run.keys)
    return np.asarray(run.lengths), np.asarray(run.keys)


def assert_runs_equal(a, b):
    (la, ka), (lb, kb) = _host(a), _host(b)
    assert la.dtype == lb.dtype and ka.dtype == kb.dtype
    np.testing.assert_array_equal(ka, kb)
    np.testing.assert_array_equal(la, lb)


@pytest.fixture(scope="module")
def ref_run():
    """The reference's mesh sort of the 509 words over one CPU device
    repeated 8 ways."""
    return ref_chunked_sort(KEYS, devices=[jax.devices()[0]] * 8)


@pytest.fixture(scope="module")
def oracle():
    return distributed_chunked_sort_lex(KEYS, devices=DEVS8)


# ---------------------------------------------------------------------------
# the cases of tests/test_distributed_chunked.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ["auto", "tournament", "kway_kernel"])
def test_distributed_chunked_bit_identical_to_oracle(engine, ref_run):
    """509 words over 8 destinations, chunks of at most 64 rows, with
    ``validate='full'``: equal to the reference's mesh sort, to the
    single-process chunked pipeline and to the shortlex order, whichever
    combine engine runs."""
    run = distributed_chunked_sort_lex(KEYS, devices=DEVS8,
                                       validate="full", merge_engine=engine)
    assert int(run.keys.shape[0]) == 509
    assert_runs_equal(run, ref_run)
    assert_runs_equal(run, chunked_sort_packed(KEYS, chunk_size=64,
                                               device="cpu"))
    assert unpack_words(to_numpy(run.keys)) == SHORTLEX


def test_exchange_and_combine_failures_recover_bit_identical(oracle):
    """Injected ``StageFailure`` mid run-exchange and mid streaming-combine:
    both stages are pure functions of their input runs, so supervised retry
    recovers output bit-identical to the no-failure run."""
    inj = StageFailureInjector(fail_at={"run_exchange": {0},
                                        "streaming_combine": {0, 2}})
    sup = SortSupervisor(policy=RetryPolicy(max_retries=3), injector=inj)
    run = distributed_chunked_sort_lex(KEYS, devices=DEVS8, supervisor=sup,
                                       validate="full")
    assert_runs_equal(run, oracle)
    assert ("run_exchange", 0, "transient") in inj.fired
    assert ("streaming_combine", 0, "transient") in inj.fired
    assert [e.action for e in sup.events] == ["retry"] * 3


def test_overflow_raise_reports_the_reference_requirement():
    with pytest.raises(CapacityOverflow) as got:
        distributed_chunked_sort_lex(KEYS, devices=DEVS8, capacity=30,
                                     on_overflow="raise")
    with pytest.raises(RefCapacityOverflow) as want:
        ref_chunked_sort(KEYS, devices=[jax.devices()[0]] * 8, capacity=30,
                         on_overflow="raise")
    assert got.value.capacity == 30 and got.value.required > 30
    assert got.value.required == want.value.required


def test_overflow_retry_is_lossless_under_unsplittable_skew():
    """One word repeated: every splitter equal, one destination takes
    everything; retry still ends (capacity doubling is bounded by n) and
    comes back lossless."""
    dup = np.asarray(pack_words(["abc"] * 400))
    oracle = distributed_chunked_sort_lex(dup, devices=DEVS8)
    run = distributed_chunked_sort_lex(dup, devices=DEVS8, capacity=80,
                                       on_overflow="retry", validate="full")
    assert_runs_equal(run, oracle)


@pytest.mark.parametrize("words", ["dup", "mixed"])
def test_overflow_clip_keeps_the_reference_elements(words):
    """'clip' keeps each destination's ``capacity`` smallest elements, as
    the reference does, and stays sorted."""
    keys = np.asarray(pack_words(["abc"] * 400)) if words == "dup" else KEYS
    clip = distributed_chunked_sort_lex(keys, devices=DEVS8, capacity=30,
                                        on_overflow="clip",
                                        validate="cheap")
    want = ref_chunked_sort(keys, devices=[jax.devices()[0]] * 8,
                            capacity=30, on_overflow="clip",
                            validate="cheap")
    assert_runs_equal(clip, want)
    if words == "dup":
        assert int(clip.keys.shape[0]) == 30
    assert np.all(np.diff(to_numpy(clip.lengths)) >= 0)


def _count_ingest():
    launches = []
    real = ingest_mod.sorted_run
    return launches, mock.patch.object(
        ingest_mod, "sorted_run",
        lambda k, **kw: launches.append(1) or real(k, **kw))


def test_store_resume_skips_completed_runs(tmp_path, oracle):
    """A job killed mid ingest resumes from its persisted per-destination
    runs (only the missing chunks sort), and a fully persisted store
    resumes with zero chunk sorts — bit-identical throughout."""
    store = RunStore(str(tmp_path))
    inj = StageFailureInjector(fail_at={"ingest_chunk": {2, 3, 4}})
    sup = SortSupervisor(policy=RetryPolicy(max_retries=2), injector=inj)
    with pytest.raises(StageFailure):
        distributed_chunked_sort_lex(KEYS, devices=DEVS8, store=store,
                                     supervisor=sup)
    assert store.completed() == [0, 1]
    launches, patch = _count_ingest()
    with patch:
        run = distributed_chunked_sort_lex(KEYS, devices=DEVS8, store=store,
                                           validate="full")
    assert_runs_equal(run, oracle)
    assert len(launches) == 6            # chunks 0-1 loaded, 2-7 sorted
    assert store.completed() == list(range(8))
    with patch:
        run2 = distributed_chunked_sort_lex(KEYS, devices=DEVS8,
                                            store=store, validate="full")
    assert_runs_equal(run2, oracle)
    assert len(launches) == 6            # a pure load: no new sort


def test_single_device_degenerate_equals_pipeline():
    keys = np.asarray(pack_words(_words(150, 1)))
    run = distributed_chunked_sort_lex(keys, devices=[CPU], validate="full")
    assert_runs_equal(run, chunked_sort_packed(keys, chunk_size=150,
                                               device="cpu"))


def test_empty_input_and_bad_args():
    empty = np.zeros((0, 2), np.uint32)
    run = distributed_chunked_sort_lex(empty, devices=DEVS8)
    assert run.keys.shape[0] == 0 and run.lengths.shape[0] == 0
    assert tuple(run.keys.shape) == (0, 2)
    keys = np.asarray(pack_words(_words(20, 2)))
    with pytest.raises(ValueError, match="validate"):
        distributed_chunked_sort_lex(keys, devices=DEVS8, validate="bogus")
    with pytest.raises(ValueError, match="on_overflow"):
        distributed_chunked_sort_lex(keys, devices=DEVS8,
                                     on_overflow="bogus")


def test_kill_between_exchange_and_combine_resumes_shard_granular(
        tmp_path, oracle):
    """A job killed mid combine (after the exchange, two destinations
    landed) resumes with ZERO chunk sorts — every run reloads from the run
    store and the exchange replays as a pure function of them — and
    re-merges only the destinations whose shards never landed; a second
    resume merges nothing. Bit-identical throughout."""
    run_store = RunStore(str(tmp_path / "runs"))
    shard_store = ShardStore(str(tmp_path / "shards"))
    inj = StageFailureInjector(kill_at={"streaming_combine": {2}})
    sup = SortSupervisor(policy=RetryPolicy(max_retries=2), injector=inj)
    with pytest.raises(ProcessKilled) as e:
        distributed_chunked_sort_lex(KEYS, devices=DEVS8, store=run_store,
                                     shard_store=shard_store,
                                     supervisor=sup)
    assert e.value.stage == "streaming_combine"
    assert run_store.completed() == list(range(8))
    assert shard_store.completed() == [0, 1]
    launches, patch = _count_ingest()
    with patch, mock.patch.object(merge_mod, "merge_runs",
                                  side_effect=merge_mod.merge_runs) as merges:
        res = distributed_chunked_sort_lex(KEYS, devices=DEVS8,
                                           store=run_store,
                                           shard_store=shard_store,
                                           validate="full")
    assert len(launches) == 0
    assert merges.call_count == 6        # only destinations 2-7
    assert shard_store.completed() == list(range(8))
    assert_runs_equal(res.to_run(validate="full", device="cpu"), oracle)
    with mock.patch.object(merge_mod, "merge_runs",
                           side_effect=merge_mod.merge_runs) as merges2:
        res2 = distributed_chunked_sort_lex(KEYS, devices=DEVS8,
                                            store=run_store,
                                            shard_store=shard_store,
                                            validate="full")
    assert merges2.call_count == 0       # double resume: pure reload
    assert_runs_equal(res2.to_run(device="cpu"), oracle)


def test_mesh_shard_spill_bit_identical(tmp_path, oracle):
    """Spill mode (``gather=False``): one shard per destination, the full
    metadata gate green, and the materialised result the gathered one."""
    sharded = distributed_chunked_sort_lex(
        KEYS, devices=DEVS8, shard_store=ShardStore(str(tmp_path)),
        validate="full")
    assert isinstance(sharded, ShardedRun)
    assert len(sharded.manifests) == 8
    assert sharded.count == 509
    assert_runs_equal(sharded.to_run(validate="full", device="cpu"), oracle)


def test_mesh_speculative_combine_bit_identical(oracle):
    """A straggling combine destination (injected fire-once slowness) gets
    a backup replica; the digest-confirmed winner keeps the output
    bit-identical."""
    inj = StageFailureInjector(slow_at={"streaming_combine": {5: 2.0}})
    sup = SortSupervisor(
        injector=inj,
        speculation=SpeculationPolicy(
            monitor=StragglerMonitor(warmup=3, min_ratio=3.0),
            min_wait=0.05))
    run = distributed_chunked_sort_lex(KEYS, devices=DEVS8, supervisor=sup,
                                       validate="full")
    assert_runs_equal(run, oracle)
    assert ("streaming_combine", 5, "slow") in inj.fired
    actions = [e.action for e in sup.events]
    assert "speculate" in actions and "speculation_confirmed" in actions


def test_run_distributed_remeshes_onto_fewer_destinations(oracle):
    """``SortSupervisor.run_distributed``'s mesh use: ``make_mesh(p)``
    gives p destinations; a device failure in the exchange re-runs the sort
    on the survivors, bit-identically."""
    sup = SortSupervisor(injector=StageFailureInjector(
        device_fail_at={"exchange": {0}}, failed_devices=3))
    used = []
    run = sup.run_distributed(
        lambda p: used.append(p) or [CPU] * p, 8,
        lambda devs: distributed_chunked_sort_lex(KEYS, devices=devs,
                                                  validate="full"))
    assert used == [5]
    assert_runs_equal(run, oracle)


def test_default_destinations_are_the_local_cards():
    """With no ``devices`` and no ``mesh`` the destinations are every
    local card; here, where there is none, that raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CPU-only branch does not apply")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed_chunked_sort_lex(KEYS)


# ---------------------------------------------------------------------------
# the mesh cases of tests/test_shards.py (4 destinations, ~120 words)
# ---------------------------------------------------------------------------

def test_spill_bit_identical_to_gather(tmp_path):
    words = _words(120, 0)
    keys = np.asarray(pack_words(words))
    gathered = distributed_chunked_sort_lex(keys, devices=DEVS4,
                                            validate="full")
    sharded = distributed_chunked_sort_lex(
        keys, devices=DEVS4, shard_store=ShardStore(str(tmp_path)),
        validate="full")
    assert isinstance(sharded, ShardedRun)
    assert len(sharded.manifests) == 4
    assert sharded.count == len(words)
    run = sharded.to_run(validate="full", device="cpu")
    assert_runs_equal(run, gathered)
    shortlex = sorted(words, key=lambda w: (len(w.encode()), w.encode()))
    assert unpack_words(to_numpy(run.keys)) == shortlex


def test_spill_with_gather_returns_run_and_persists_shards(tmp_path):
    keys = np.asarray(pack_words(_words(90, 3)))
    store = ShardStore(str(tmp_path))
    run = distributed_chunked_sort_lex(keys, devices=DEVS4,
                                       shard_store=store, gather=True,
                                       validate="full")
    assert int(run.keys.shape[0]) == 90
    assert store.completed() == [0, 1, 2, 3]


def test_gather_false_without_store_rejected():
    with pytest.raises(ValueError, match="shard_store"):
        distributed_chunked_sort_lex(np.zeros((4, 2), np.uint32),
                                     devices=[CPU] * 2, gather=False)


def test_shard_resume_skips_completed_merges(tmp_path):
    keys = np.asarray(pack_words(_words(120, 0)))
    store = ShardStore(str(tmp_path))
    first = distributed_chunked_sort_lex(keys, devices=DEVS4,
                                         shard_store=store, validate="full")
    with mock.patch.object(merge_mod, "merge_runs",
                           side_effect=merge_mod.merge_runs) as spy:
        again = distributed_chunked_sort_lex(keys, devices=DEVS4,
                                             shard_store=store,
                                             validate="full")
    assert spy.call_count == 0
    assert_runs_equal(first.to_run(device="cpu"), again.to_run(device="cpu"))


def test_torn_shard_self_heals_on_resume(tmp_path):
    """A shard truncated after landing fails its load on resume and is
    recomputed: only that destination merges again, and the result stays
    bit-identical."""
    keys = np.asarray(pack_words(_words(120, 0)))
    store = ShardStore(str(tmp_path))
    first = distributed_chunked_sort_lex(keys, devices=DEVS4,
                                         shard_store=store, validate="full")
    with open(os.path.join(str(tmp_path), "step_2", "keys.npy"), "r+b") as f:
        f.truncate(32)
    with mock.patch.object(merge_mod, "merge_runs",
                           side_effect=merge_mod.merge_runs) as spy:
        healed = distributed_chunked_sort_lex(keys, devices=DEVS4,
                                              shard_store=store,
                                              validate="full")
    assert spy.call_count == 1
    assert_runs_equal(first.to_run(device="cpu"),
                      healed.to_run(validate="full", device="cpu"))


def test_stale_shard_store_recomputes(tmp_path):
    store = ShardStore(str(tmp_path))
    distributed_chunked_sort_lex(np.asarray(pack_words(_words(100, 1))),
                                 devices=DEVS4, shard_store=store)
    new_words = _words(120, 2)
    sharded = distributed_chunked_sort_lex(
        np.asarray(pack_words(new_words)), devices=DEVS4, shard_store=store,
        validate="full")
    shortlex = sorted(new_words, key=lambda w: (len(w.encode()), w.encode()))
    assert unpack_words(to_numpy(sharded.to_run(device="cpu").keys)) == \
        shortlex


# ---------------------------------------------------------------------------
# one shard store, two packages
# ---------------------------------------------------------------------------

def test_reference_shards_resume_in_the_port_with_zero_merges(tmp_path):
    keys = np.asarray(pack_words(_words(120, 4)))
    ref = ref_chunked_sort(keys, devices=[jax.devices()[0]] * 4,
                           shard_store=RefShardStore(str(tmp_path)),
                           validate="full")
    with mock.patch.object(merge_mod, "merge_runs",
                           side_effect=merge_mod.merge_runs) as spy:
        got = distributed_chunked_sort_lex(
            keys, devices=DEVS4, shard_store=ShardStore(str(tmp_path)),
            validate="full")
    assert spy.call_count == 0
    assert_runs_equal(got.to_run(validate="full", device="cpu"),
                      ref.to_run(validate="full"))


def test_port_shards_resume_in_the_reference_with_zero_merges(tmp_path):
    keys = np.asarray(pack_words(_words(120, 5)))
    got = distributed_chunked_sort_lex(
        keys, devices=DEVS4, shard_store=ShardStore(str(tmp_path)),
        validate="full")
    with mock.patch.object(ref_merge_mod, "merge_runs",
                           side_effect=ref_merge_mod.merge_runs) as spy:
        ref = ref_chunked_sort(keys, devices=[jax.devices()[0]] * 4,
                               shard_store=RefShardStore(str(tmp_path)),
                               validate="full")
    assert spy.call_count == 0
    assert_runs_equal(ref.to_run(validate="full"),
                      got.to_run(validate="full", device="cpu"))
