"""The port's run tier (``repro_torch.pipeline``) against the reference's
(``repro.pipeline``), on the CPU (the kernels' plain versions): the chunked
sorts with every merge engine and the validation gate, the run manifests,
the merge front-end, and the numpy copy of the validation module.

The reference runs its chunked sort with ``merge_engine='kway'`` and
``algorithm='xla'`` (XLA's sort inside each chunk, so a test takes seconds,
not minutes); a shortlex sort of words has one answer, so the merged
lengths and keys must agree bit for bit whatever the engines."""

import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.packing import pack_words
from repro.pipeline import chunked_sort_packed as ref_chunked_packed
from repro.pipeline import chunked_sort_words as ref_chunked_words
from repro.pipeline import merge_runs as ref_merge_runs
from repro.pipeline import validate as rval
from repro.pipeline.ingest import sorted_run as ref_sorted_run
from repro.pipeline.manifest import RunManifest as RefManifest
from repro_torch.data import synthetic_words
from repro_torch.interop import run_to_device, run_to_numpy, to_numpy
from repro_torch.kernels import KERNELS
from repro_torch.pipeline import (RunManifest, RunStore, SortedRun,
                                  ValidationError, check_chunked,
                                  chunked_sort_packed, chunked_sort_words,
                                  merge_runs, merge_two, sorted_run)
from repro_torch.pipeline import validate as tval
from repro_torch.pipeline.ingest import _prefetch_map
from repro_torch.runtime import (CapacityOverflow, SortSupervisor,
                                 StageFailureInjector)

_ENGINES = ("auto", "kway", "kway_kernel", "tournament")
_CASES = {"synthetic-3000": (lambda: synthetic_words(3000, seed=3), 256),
          "synthetic-2000": (lambda: synthetic_words(2000, seed=4), 512),
          "words-32-bytes": (lambda: _long_words(700, seed=5), 128)}


def _long_words(n, seed):
    """Words of 1 to 32 bytes over a small alphabet: 8 key lanes, so the
    merged tuple is 18 arrays (9 compare lanes, 9 data lanes)."""
    rng = np.random.default_rng(seed)
    return ["".join(rng.choice(list("abé"), int(ln)))
            for ln in rng.integers(1, 17, n)] + ["x" * 32]


def _shortlex(words):
    return sorted(words, key=lambda w: (len(w.encode()), w.encode()))


@pytest.fixture(scope="module")
def reference():
    """The reference's chunked sort of each case, computed once."""
    out = {}
    for name, (make, chunk) in _CASES.items():
        words = make()
        out[name] = (words, chunk, ref_chunked_words(
            words, chunk_size=chunk, algorithm="xla", merge_engine="kway",
            validate="full"))
    return out


@pytest.mark.parametrize("engine", _ENGINES)
@pytest.mark.parametrize("case", list(_CASES))
def test_chunked_sort_words_matches_reference(reference, case, engine):
    words, chunk, want = reference[case]
    got = chunked_sort_words(words, chunk_size=chunk, validate="full",
                             merge_engine=engine, device="cpu")
    assert got == want == _shortlex(words)


@pytest.mark.parametrize("engine", _ENGINES)
def test_chunked_sort_packed_matches_reference(engine):
    keys = pack_words(synthetic_words(2500, seed=7))
    got = chunked_sort_packed(keys, chunk_size=384, validate="full",
                              merge_engine=engine, device="cpu")
    want = ref_chunked_packed(jnp.asarray(keys), chunk_size=384,
                              algorithm="xla", merge_engine="kway")
    np.testing.assert_array_equal(to_numpy(got.lengths),
                                  np.asarray(want.lengths))
    np.testing.assert_array_equal(to_numpy(got.keys), np.asarray(want.keys))
    # the reference's own gate passes on the port's runs and merge
    runs = [sorted_run(keys[s:s + 384], capacity=384, device="cpu")
            for s in range(0, len(keys), 384)]
    mans = [RefManifest.from_run(_ref_view(r), i) for i, r in enumerate(runs)]
    rval.check_chunked([_ref_view(r) for r in runs], mans, _ref_view(got),
                       mode="full")


class _RefView:
    def __init__(self, lengths, keys):
        self.lengths, self.keys = lengths, keys


def _ref_view(run):
    lengths, keys, _ = run_to_numpy(run)
    return _RefView(lengths, keys)


def test_chunked_sort_packed_takes_a_tensor_and_a_single_chunk():
    keys = pack_words(synthetic_words(300, seed=8))
    whole = chunked_sort_packed(keys, chunk_size=4096, device="cpu")
    from_tensor = chunked_sort_packed(torch.from_numpy(keys.view(np.int32))
                                      .view(torch.uint32), chunk_size=100,
                                      validate="cheap", device="cpu")
    for a, b in ((whole.lengths, from_tensor.lengths),
                 (whole.keys, from_tensor.keys)):
        np.testing.assert_array_equal(to_numpy(a), to_numpy(b))
    assert whole.packed is not None          # one chunk: the run itself


def test_chunked_edge_cases():
    assert chunked_sort_words([], device="cpu") == []
    assert chunked_sort_words(["b", "a"], chunk_size=1,
                              device="cpu") == ["a", "b"]
    empty = chunked_sort_packed(np.zeros((0, 2), np.uint32), device="cpu")
    assert empty.lengths.shape == (0,) and empty.keys.shape == (0, 2)
    for bad in (dict(validate="most"), dict(chunk_size=0)):
        with pytest.raises(ValueError):
            chunked_sort_words(["a"], device="cpu", **bad)
    # the robustness arguments work at the edges too: one word, one chunk
    with tempfile.TemporaryDirectory() as d:
        store = RunStore(d)
        assert chunked_sort_words(["b", "a"], chunk_size=1, store=store,
                                  device="cpu") == ["a", "b"]
        assert store.completed() == [0, 1]
        assert chunked_sort_words(["b", "a"], chunk_size=1, store=store,
                                  device="cpu") == ["a", "b"]
    sup = SortSupervisor(injector=StageFailureInjector(
        fail_at={"ingest_chunk": {0}}))
    one = chunked_sort_packed(np.ones((1, 1), np.uint32), supervisor=sup,
                              device="cpu")
    assert one.lengths.tolist() == [4]
    assert [e.action for e in sup.events] == ["retry"]


@pytest.mark.parametrize("policy", ["raise", "retry", "clip"])
def test_overflow_policies_reach_every_chunk(policy):
    words = synthetic_words(600, seed=9)
    if policy == "raise":
        with pytest.raises(CapacityOverflow):
            chunked_sort_words(words, chunk_size=200, capacity=20,
                               device="cpu")
        return
    got = chunked_sort_words(words, chunk_size=200, capacity=20,
                             on_overflow=policy, device="cpu")
    want = ref_chunked_words(words, chunk_size=200, capacity=20,
                             algorithm="xla", on_overflow=policy)
    assert got == want
    assert (got == _shortlex(words)) == (policy == "retry")


def test_merge_runs_of_reference_runs_match_reference_merge():
    """Runs sorted by the reference, carried over by ``interop``, merged by
    the port with every engine: the reference's merge, bit for bit."""
    chunks = [pack_words(synthetic_words(n, seed=n), width=16)
              for n in (300, 250, 1, 400)]
    ref_runs = [ref_sorted_run(jnp.asarray(c), algorithm="xla")
                for c in chunks]
    want = ref_merge_runs([r.lanes() for r in ref_runs], engine="kway",
                          cmp_runs=[r.cmp_lanes() for r in ref_runs])
    runs = [run_to_device(r.lengths, r.keys, r.packed, device="cpu")
            for r in ref_runs]
    for r, ref in zip(runs, ref_runs):
        back = run_to_numpy(r)
        np.testing.assert_array_equal(back[1], np.asarray(ref.keys))
        for p, q in zip(back[2], ref.packed):
            np.testing.assert_array_equal(p, np.asarray(q))
    for engine in _ENGINES:
        got = merge_runs([r.lanes() for r in runs], engine=engine,
                         cmp_runs=[r.cmp_lanes() for r in runs])
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(to_numpy(g), np.asarray(w))


def test_merge_runs_reconciles_manifests_and_trivial_inputs():
    runs = [sorted_run(pack_words(synthetic_words(n, seed=n)), device="cpu")
            for n in (40, 30)]
    mans = [RunManifest.from_run(r, i) for i, r in enumerate(runs)]
    lanes = [r.lanes() for r in runs]
    assert len(merge_runs(lanes, manifests=mans)[0]) == 70
    short = (lanes[0][0][:-1],) + tuple(x[:-1] for x in lanes[0][1:])
    with pytest.raises(ValidationError, match="manifest"):
        merge_runs([short, lanes[1]], manifests=mans)
    with pytest.raises(ValueError, match="engine"):
        merge_runs(lanes, engine="bogus")
    sup = SortSupervisor(injector=StageFailureInjector(
        fail_at={"streaming_combine": {0}}))
    for g, w in zip(merge_runs(lanes, supervisor=sup), merge_runs(lanes)):
        assert torch.equal(g, w)
    assert [e.stage for e in sup.events] == ["streaming_combine"]
    assert merge_runs([]) == ()
    assert merge_runs(lanes[:1]) == lanes[0]
    merged = merge_two(lanes[0], lanes[1])
    for g, w in zip(merged, merge_runs(lanes)):
        assert torch.equal(g, w)


def test_manifest_matches_the_reference_manifest():
    run = sorted_run(pack_words(synthetic_words(500, seed=10)), device="cpu")
    got = RunManifest.from_run(run, 3)
    want = RefManifest.from_run(_ref_view(run), 3)
    assert got.to_json() == want.to_json()
    assert RunManifest.from_json(got.to_json()) == got


def test_validation_gate_catches_seeded_corruption():
    words = synthetic_words(900, seed=11)
    runs = [sorted_run(pack_words(words[s:s + 300], width=16), device="cpu")
            for s in range(0, 900, 300)]
    mans = [RunManifest.from_run(r, i) for i, r in enumerate(runs)]
    merged = SortedRun.from_lanes(merge_runs(
        [r.lanes() for r in runs], cmp_runs=[r.cmp_lanes() for r in runs]))
    check_chunked(runs, mans, merged, mode="full")
    keys = merged.keys.clone()
    keys.view(torch.int32)[450, 0] ^= 1           # one flipped bit
    bad = SortedRun(lengths=merged.lengths, keys=keys)
    with pytest.raises(ValidationError):
        check_chunked(runs, mans, bad, mode="full")
    dropped = SortedRun(lengths=merged.lengths[1:], keys=merged.keys[1:])
    with pytest.raises(ValidationError, match="lost or duplicated"):
        check_chunked(runs, mans, dropped, mode="cheap")
    reverse = torch.arange(merged.keys.shape[0] - 1, -1, -1)
    swapped = SortedRun(lengths=merged.lengths[reverse],
                        keys=merged.keys[reverse])
    with pytest.raises(ValidationError, match="not sorted"):
        check_chunked(runs, mans, swapped, mode="cheap")


@pytest.mark.parametrize("dtype", [np.uint32, np.int32, np.float32])
def test_validate_copy_agrees_with_reference(dtype):
    rng = np.random.default_rng(12)
    a = rng.integers(0, 2**32, (400, 3), dtype=np.uint64).astype(np.uint32)
    if dtype == np.float32:
        a[rng.random((400, 3)) < 0.2] = 0x7FC00001
        a[rng.random((400, 3)) < 0.1] = 0x80000000
    a = a.view(dtype)
    lanes = [a[:, i] for i in range(3)]
    t_lanes = [torch.from_numpy(np.ascontiguousarray(l)) if dtype != np.uint32
               else torch.from_numpy(np.ascontiguousarray(l).view(np.int32))
               .view(torch.uint32) for l in lanes]
    assert tval.multiset_digest(t_lanes) == rval.multiset_digest(lanes)
    assert tval.keys_digest(a) == rval.keys_digest(a)
    np.testing.assert_array_equal(tval.order_bits_view(t_lanes[0]),
                                  rval.order_bits_view(lanes[0]))
    lengths = rng.integers(0, 9, 400).astype(np.int32)
    np.testing.assert_array_equal(
        tval.length_histogram_of(torch.from_numpy(lengths), 9),
        rval.length_histogram_of(lengths, 9))
    reverse = torch.arange(399, -1, -1)
    tval.check_multiset(t_lanes, [l[reverse] for l in t_lanes])
    with pytest.raises(ValidationError):
        tval.check_multiset(t_lanes, [l[:-1] for l in t_lanes])
    with pytest.raises(ValidationError):
        tval.check_lanes_sorted(t_lanes)


def test_prefetch_map_keeps_order_and_runs_one_ahead():
    seen = []

    def fn(x):
        seen.append(x)
        return x * 10

    got = []
    for y in _prefetch_map(fn, range(5)):
        got.append(y)
        assert len(seen) <= len(got) + 1
    assert got == [0, 10, 20, 30, 40]
    assert list(_prefetch_map(fn, [])) == []


def test_cpu_run_launches_no_kernel():
    for k in KERNELS.values():
        k.launches = 0
    chunked_sort_words(synthetic_words(1200, seed=13), chunk_size=300,
                       merge_engine="kway_kernel", device="cpu")
    assert all(k.launches == 0 for k in KERNELS.values())
