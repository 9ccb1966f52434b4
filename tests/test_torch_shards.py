"""The port's shard store (``repro_torch.pipeline.shards``) and its
metadata-only gate (``validate.check_sharded``) against the reference's:
the store and gate cases of ``tests/test_shards.py`` (its spill and resume
cases of ``distributed_chunked_sort_lex`` are in
``tests/test_torch_distributed_chunked.py``),
each gate verdict the reference's on the same manifests, and shards written
by either package loaded by the other; plus the port's copy of the length
histogram utilities against ``repro.pipeline.histogram``."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.pipeline import RunManifest as RefManifest
from repro.pipeline import ShardedRun as RefShardedRun
from repro.pipeline import ShardStore as RefShardStore
from repro.pipeline import SortedRun as RefSortedRun
from repro.pipeline import ValidationError as RefValidationError
from repro.pipeline import check_sharded as ref_check_sharded
from repro.pipeline import histogram as ref_hist
from repro_torch.checkpoint import CorruptSnapshotError
from repro_torch.core.packing import pack_words
from repro_torch.data import synthetic_words
from repro_torch.interop import run_to_device, to_device, to_numpy
from repro_torch.pipeline import (RunManifest, RunStore, ShardedRun,
                                  ShardStore, SortedRun, ValidationError,
                                  assign_buckets, bucket_of, check_sharded,
                                  chunked_sort_words, length_histogram,
                                  quantile_bounds)


def _run_of(rows):
    """A SortedRun from shortlex-ordered (length, *lanes) rows."""
    lengths = np.asarray([r[0] for r in rows], np.int32)
    keys = np.asarray([list(r[1:]) for r in rows], np.uint32) \
        if rows else np.zeros((0, 2), np.uint32)
    return SortedRun(lengths=to_device(lengths, "cpu"),
                     keys=to_device(keys, "cpu"))


def _man(run, dest):
    return RunManifest.from_run(run, dest)


_ROWS = [(1, 0x61000000, 0), (2, 0x61620000, 0), (3, 0x61626300, 0),
         (4, 0x61626364, 0), (5, 0x61626364, 0x65000000)]


def _same_run(a, b):
    for x, y in ((a.lengths, b.lengths), (a.keys, b.keys)):
        x = to_numpy(x) if isinstance(x, torch.Tensor) else np.asarray(x)
        y = to_numpy(y) if isinstance(y, torch.Tensor) else np.asarray(y)
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------------------
# ShardStore
# ---------------------------------------------------------------------------

def test_shard_store_roundtrip_load_and_drop(tmp_path):
    store = ShardStore(str(tmp_path))
    a, b = _run_of(_ROWS[:3]), _run_of(_ROWS[3:])
    store.put(_man(a, 0), a)
    store.put(_man(b, 1), b)
    assert store.completed() == [0, 1]
    assert store.manifest(1) == _man(b, 1)
    sharded = ShardedRun(store=store, manifests=(_man(a, 0), _man(b, 1)))
    assert sharded.count == 5
    _same_run(sharded.load_shard(1, validate="full", device="cpu"), b)
    whole = sharded.to_run(validate="full", device="cpu")
    _same_run(whole, _run_of(_ROWS))
    store.drop(0)
    assert store.completed() == [1]
    store.drop(0)                      # dropping a missing shard is a no-op
    assert store.completed() == [1]


def test_shard_store_sweeps_tmp_droppings_on_open(tmp_path):
    store = ShardStore(str(tmp_path))
    run = _run_of(_ROWS[:2])
    store.put(_man(run, 0), run)
    torn = tmp_path / ".tmp_3"
    torn.mkdir()
    (torn / "keys.npy").write_bytes(b"partial")
    reopened = ShardStore(str(tmp_path))
    assert not torn.exists()
    assert reopened.completed() == [0]


def test_load_shard_full_validate_catches_tampering(tmp_path):
    store = ShardStore(str(tmp_path))
    run = _run_of(_ROWS)
    store.put(_man(run, 0), run)
    victim = os.path.join(str(tmp_path), "step_0", "keys.npy")
    arr = np.load(victim)
    arr[2, 0] ^= 1                    # sortedness-preserving content flip
    np.save(victim, arr)
    sharded = ShardedRun(store=store, manifests=(_man(run, 0),))
    with pytest.raises(ValidationError):
        sharded.load_shard(0, validate="full", device="cpu")
    with open(victim, "r+b") as f:
        f.truncate(40)
    with pytest.raises(CorruptSnapshotError):
        sharded.load_shard(0, device="cpu")


def test_empty_sharded_run_materialises_empty(tmp_path):
    sharded = ShardedRun(store=ShardStore(str(tmp_path)), manifests=())
    assert sharded.count == 0
    run = sharded.to_run(device="cpu")
    assert run.keys.shape == (0, 0) and run.keys.dtype == torch.uint32
    assert run.lengths.shape == (0,) and run.lengths.dtype == torch.int32


def test_to_run_defaults_to_the_card(tmp_path):
    sharded = ShardedRun(store=ShardStore(str(tmp_path)), manifests=())
    if torch.cuda.is_available():
        assert sharded.to_run().keys.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sharded.to_run()


def test_shards_of_a_chunked_sort_round_trip(tmp_path):
    """A port run split into destination shards: the shards gate against
    the ingest runs' manifests, and ``to_run`` gives the run back."""
    words = synthetic_words(700, seed=3)
    runs = RunStore(str(tmp_path / "runs"))
    out = chunked_sort_words(words, chunk_size=128, store=runs,
                             device="cpu")
    run_mans = [runs.manifest(i) for i in runs.completed()]
    keys = pack_words(out)
    merged = SortedRun(
        lengths=to_device(np.asarray([len(w.encode()) for w in out],
                                     np.int32), "cpu"),
        keys=to_device(keys, "cpu"))
    shards = ShardStore(str(tmp_path / "shards"))
    cuts = [0, 100, 100, 333, 700]          # one empty destination
    mans = []
    for d, (lo, hi) in enumerate(zip(cuts, cuts[1:])):
        part = SortedRun(lengths=merged.lengths[lo:hi],
                         keys=merged.keys[lo:hi])
        mans.append(_man(part, d))
        shards.put(mans[-1], part)
    check_sharded(run_mans, mans, mode="full")
    ref_check_sharded(run_mans, mans, mode="full")
    _same_run(ShardedRun(store=shards, manifests=tuple(mans)).to_run(
        validate="full", device="cpu"), merged)


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------

def _ref_run(rows):
    lengths = jnp.asarray([r[0] for r in rows], jnp.int32)
    keys = jnp.asarray([list(r[1:]) for r in rows], jnp.uint32)
    return RefSortedRun(lengths=lengths, keys=keys)


def test_reference_shards_load_in_the_port(tmp_path):
    ref_store = RefShardStore(str(tmp_path))
    a, b = _ref_run(_ROWS[:2]), _ref_run(_ROWS[2:])
    ref_mans = (RefManifest.from_run(a, 0), RefManifest.from_run(b, 1))
    ref_store.put(ref_mans[0], a)
    ref_store.put(ref_mans[1], b)
    store = ShardStore(str(tmp_path))
    mans = tuple(store.manifest(i) for i in store.completed())
    assert [m.to_json() for m in mans] == [m.to_json() for m in ref_mans]
    whole = ShardedRun(store=store, manifests=mans).to_run(
        validate="full", device="cpu")
    _same_run(whole, _run_of(_ROWS))


def test_port_shards_load_in_the_reference(tmp_path):
    store = ShardStore(str(tmp_path))
    a, b = _run_of(_ROWS[:4]), _run_of(_ROWS[4:])
    store.put(_man(a, 0), a)
    store.put(_man(b, 1), b)
    ref_store = RefShardStore(str(tmp_path))
    mans = tuple(ref_store.manifest(i) for i in ref_store.completed())
    whole = RefShardedRun(store=ref_store, manifests=mans).to_run(
        validate="full")
    _same_run(whole, _run_of(_ROWS))
    back = run_to_device(whole.lengths, whole.keys, device="cpu")
    _same_run(back, _run_of(_ROWS))


# ---------------------------------------------------------------------------
# check_sharded: each verdict the reference's
# ---------------------------------------------------------------------------

def _gate_fixtures():
    runs = [_run_of(_ROWS[:3]), _run_of(_ROWS[3:])]
    shards = [_run_of(_ROWS[:2]), _run_of(_ROWS[2:])]
    return ([_man(r, i) for i, r in enumerate(runs)],
            [_man(s, i) for i, s in enumerate(shards)])


def _tampered():
    rows = list(_ROWS[2:])
    rows[1] = (rows[1][0], rows[1][1] ^ 1, rows[1][2])
    return [_man(_run_of(_ROWS[:2]), 0), _man(_run_of(rows), 1)]


_GATE_CASES = {
    "conserving": (lambda r, s: s, None, None),
    "count-loss": (lambda r, s: s[:1], "lost or duplicated",
                   "lost or duplicated"),
    "histogram-swap": (lambda r, s: [_man(_run_of(
        [(1, 0x61000000, 0), (1, 0x62000000, 0)]), 0), s[1]],
        "histogram", "histogram"),
    "boundary-disorder": (lambda r, s: list(reversed(s)), "boundary",
                          "boundary"),
    "digest-mismatch": (lambda r, s: _tampered(), None, "digest"),
    "empty-shard": (lambda r, s: s + [_man(_run_of([]), 2)], None, None),
}


@pytest.mark.parametrize("mode", ["cheap", "full"])
@pytest.mark.parametrize("case", list(_GATE_CASES))
def test_check_sharded_verdicts_match_the_reference(case, mode):
    run_mans, shard_mans = _gate_fixtures()
    shard_mans = _GATE_CASES[case][0](run_mans, shard_mans)
    want = _GATE_CASES[case][1 if mode == "cheap" else 2]

    def verdict(gate, error):
        try:
            gate(run_mans, shard_mans, mode=mode)
        except error as e:
            return str(e)
        return None

    got = verdict(check_sharded, ValidationError)
    assert got == verdict(ref_check_sharded, RefValidationError)
    if want is None:
        assert got is None
    else:
        assert want in got


# ---------------------------------------------------------------------------
# the length histogram utilities
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_histogram_utilities_match_the_reference(seed):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, 40, 500)
    np.testing.assert_array_equal(length_histogram(lengths),
                                  ref_hist.length_histogram(lengths))
    np.testing.assert_array_equal(length_histogram(lengths, num_bins=10),
                                  ref_hist.length_histogram(lengths, 10))
    bounds = quantile_bounds(lengths, n_buckets=6)
    assert bounds == ref_hist.quantile_bounds(lengths, n_buckets=6)
    np.testing.assert_array_equal(assign_buckets(lengths, bounds),
                                  ref_hist.assign_buckets(lengths, bounds))
    assert [bucket_of(l, bounds) for l in (0, 17, 100)] == \
        [ref_hist.bucket_of(l, bounds) for l in (0, 17, 100)]


def test_histogram_edge_cases():
    assert length_histogram([]).shape == (0,)
    assert quantile_bounds([]) == []
    assert assign_buckets([], []).shape == (0,)
    with pytest.raises(ValueError, match="no buckets"):
        assign_buckets([3], [])
    with pytest.raises(ValueError, match="ascending"):
        assign_buckets([3], [4, 2])
    with pytest.raises(ValueError, match="exceeds"):
        assign_buckets([9], [4, 8], clamp=False)
    assert bucket_of(9, [4, 8]) == 1
