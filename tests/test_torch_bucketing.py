"""The port's main path as a whole — ``sorted_packed`` and
``bucketed_sort_words`` — against the reference, on the CPU (the kernels'
plain versions).

Up to a bucket capacity of 128 the reference runs its own kernel path,
``algorithm='pallas'`` (distribute + OETS in interpret mode). Above 128
it runs ``algorithm='xla'``: the same function with XLA's sort in place of
the kernels. A key-only shortlex sort has one answer, so lengths, keys and
packed lanes must agree bit for bit on every path."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bucketing as rb
from repro.core.packing import pack_words
from repro.runtime.failure import CapacityOverflow as RefOverflow
from repro.testing.generators import make_words
from repro_torch.core import bucketing as tb
from repro_torch.data import synthetic_words
from repro_torch.interop import to_device, to_numpy
from repro_torch.kernels import KERNELS
from repro_torch.runtime import CapacityOverflow


def _shortlex(words):
    return sorted(words, key=lambda w: (len(w.encode()), w.encode()))


def _assert_same(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) == 3
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(to_numpy(g), np.asarray(w))
    assert len(got[2]) == len(want[2])
    for g, w in zip(got[2], want[2]):
        np.testing.assert_array_equal(to_numpy(g), np.asarray(w))


@pytest.mark.parametrize("words", [
    pytest.param(synthetic_words(400, seed=1), id="synthetic-400"),
    pytest.param(make_words("random", np.random.default_rng(2)), id="random"),
    pytest.param(make_words("sentinel", np.random.default_rng(3)),
                 id="sentinel"),
])
def test_small_capacity_matches_reference_kernel_path(words):
    keys = pack_words(words)
    got = tb.sorted_packed(keys, return_packed=True, device="cpu")
    assert int(got[0].shape[0]) == len(words)
    want = rb.sorted_packed(jnp.asarray(keys), algorithm="pallas",
                            return_packed=True)
    _assert_same(got, want)


@pytest.mark.parametrize("n,block", [(1500, 128), (1500, None),
                                     (6000, None)])
def test_large_capacity_matches_reference(n, block):
    """``block=128`` drives blocksort (local bitonic + merge rounds) at a
    capacity of ~300; ``None`` lets the tier follow the capacity: bitonic at
    ~300, blocksort past 1024 at 6000 words."""
    keys = pack_words(synthetic_words(n, seed=n))
    got = tb.sorted_packed(keys, return_packed=True, device="cpu",
                           block_size=block)
    want = rb.sorted_packed(jnp.asarray(keys), algorithm="xla",
                            return_packed=True)
    _assert_same(got, want)


@pytest.mark.parametrize("policy", ["raise", "retry", "clip"])
def test_overflow_policies_match_reference(policy):
    keys = pack_words(synthetic_words(300, seed=4))
    capacity = 40
    if policy == "raise":
        with pytest.raises(CapacityOverflow) as got:
            tb.sorted_packed(keys, capacity=capacity, device="cpu")
        with pytest.raises(RefOverflow) as want:
            rb.sorted_packed(jnp.asarray(keys), algorithm="xla",
                             capacity=capacity)
        for field in ("capacity", "required", "dropped"):
            assert getattr(got.value, field) == getattr(want.value, field)
        return
    got = tb.sorted_packed(keys, capacity=capacity, on_overflow=policy,
                           return_packed=True, device="cpu")
    want = rb.sorted_packed(jnp.asarray(keys), algorithm="xla",
                            capacity=capacity, on_overflow=policy,
                            return_packed=True)
    _assert_same(got, want)
    assert (got[0].shape[0] < 300) == (policy == "clip")


_EDGE_WORDS = ["été", "ß", "日本語", "naïve", "", "a", "", "abcd", "abcde",
               "abcdefgh", "abcdefghijkl", "abcdefghijklmnop", "zzzz", "€",
               "abc", "ab", "b"]


@pytest.mark.parametrize("words", [
    pytest.param(_EDGE_WORDS, id="non_ascii_empty_lane_boundaries"),
    pytest.param(["solo"], id="singleton"),
    pytest.param(["x" * 8, "y" * 4, "x" * 4, "w" * 12] * 3, id="boundaries"),
])
def test_bucketed_sort_words_is_shortlex(words):
    got = tb.bucketed_sort_words(words, device="cpu")
    assert got == _shortlex(words)
    assert got == rb.bucketed_sort_words(words, algorithm="xla")


def test_bucketed_sort_words_empty_list():
    assert tb.bucketed_sort_words([], device="cpu") == []
    lens, keys = tb.sorted_packed(np.zeros((0, 2), np.uint32), device="cpu")
    assert lens.shape == (0,) and keys.shape == (0, 2)


def test_bucketize_packed_matches_reference():
    keys = pack_words(synthetic_words(500, seed=6))
    got = tb.bucketize_packed(keys, device="cpu")
    want = rb.bucketize_packed(jnp.asarray(keys))
    for field in ("keys", "counts", "lengths"):
        np.testing.assert_array_equal(to_numpy(getattr(got, field)),
                                      np.asarray(getattr(want, field)))
    assert got.dropped == want.dropped == 0


def test_bucketize_words_host_reference_is_the_same():
    words = synthetic_words(200, seed=7)
    got, want = tb.bucketize_words(words), rb.bucketize_words(words)
    for field in ("keys", "counts", "lengths"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field))


def test_interop_round_trip_of_buckets():
    """The reference's numpy bucket tensor and counts cross to the port and
    back bit for bit; the port sorts the crossed tensor like the
    reference."""
    ref = rb.bucketize_words(synthetic_words(300, seed=8))
    keys, counts = to_device((ref.keys, ref.counts), "cpu")
    assert keys.dtype == torch.uint32 and counts.dtype == torch.int32
    back = to_numpy((keys, counts))
    np.testing.assert_array_equal(back[0], ref.keys)
    np.testing.assert_array_equal(back[1], ref.counts)
    got = tb.sort_buckets(keys, counts=counts)
    want = rb.sort_buckets(jnp.asarray(ref.keys), "xla")
    np.testing.assert_array_equal(to_numpy(got), np.asarray(want))


@pytest.mark.parametrize("algorithm", ["oets", "bitonic", "xla"])
def test_unported_bucket_sorts_name_a12(algorithm):
    """The bucket sorts that waited for ROADMAP A12 run now: each sorts
    every bucket as the reference's does, bit for bit."""
    keys = np.array([[[3], [0xFFFFFFFF], [1], [3]],
                     [[0x80000000], [2], [0], [0xFFFFFFFF]]], np.uint32)
    want = rb.sort_buckets(jnp.asarray(keys), algorithm)
    got = tb.sort_buckets(to_device(keys, "cpu"), algorithm)
    np.testing.assert_array_equal(to_numpy(got), np.asarray(want))


def test_cpu_path_launches_no_kernel():
    before = {n: k.launches for n, k in KERNELS.items()}
    tb.bucketed_sort_words(synthetic_words(100, seed=9), device="cpu")
    assert before == {n: k.launches for n, k in KERNELS.items()}
    assert set(KERNELS) == {"oets_rows_lex", "bitonic_rows_lex",
                            "distribute_rows", "merge_adjacent_lex",
                            "merge_pairs_lex",
                            "merge_runs_lex", "merge_path_starts",
                            "merge_runs_kway", "kway_split", "kway_gather",
                            "partition_rows"}
