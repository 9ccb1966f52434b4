"""The port's odd-even transposition network (``repro_torch.core.oets``)
and ``sort_buckets``' four algorithms against the reference's, bit for bit,
on the reference's adversarial generators (``repro.testing.generators``):
float lanes with NaN payloads and ±0, sentinel collisions, duplicates, odd
lengths, truncated networks and multi-lane uint32 keys."""

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import bucketing as ref_bucketing
from repro.core import oets as ref
from repro.testing.generators import ADVERSARIAL, applicable, default_n, \
    fill_elements
from repro_torch.core import bucketing, oets
from repro_torch.core.packing import pack_words
from repro_torch.data import synthetic_words
from repro_torch.interop import to_device, to_numpy

DTYPES = [np.int32, np.uint32, np.float32, np.int16, np.uint8]
CASES = [(g, d) for g in ADVERSARIAL for d in DTYPES if applicable(g, d)]


def _same_bits(want, got):
    want, got = np.asarray(want), to_numpy(got)
    assert want.dtype == got.dtype and want.shape == got.shape
    np.testing.assert_array_equal(want.view(np.uint8), got.view(np.uint8))


def _cpu(x):
    return to_device(np.asarray(x), "cpu")


def _keys(gen, dtype, n=None):
    n = default_n(gen) if n is None else n
    return fill_elements(gen, np.random.default_rng(n + len(gen)), n, dtype)


@pytest.mark.parametrize("gen,dtype", CASES,
                         ids=[f"{g}-{np.dtype(d).name}" for g, d in CASES])
def test_oets_sort_kv_argsort_match_reference(gen, dtype):
    x = _keys(gen, dtype)
    _same_bits(ref.oets_sort(jnp.asarray(x)), oets.oets_sort(_cpu(x)))
    v = np.arange(x.shape[0], dtype=np.int32)[::-1].copy()
    rk, rv = ref.oets_sort_kv(jnp.asarray(x), jnp.asarray(v))
    pk, pv = oets.oets_sort_kv(_cpu(x), _cpu(v))
    _same_bits(rk, pk)
    _same_bits(rv, pv)
    _same_bits(ref.oets_argsort(jnp.asarray(x)), oets.oets_argsort(_cpu(x)))


@pytest.mark.parametrize("n", [2, 3, 95, 97])
@pytest.mark.parametrize("num_phases", [None, 0, 1, 2, 5, 16])
def test_truncated_network_and_odd_lengths_match_reference(n, num_phases):
    x = _keys("nan", np.float32, n)
    _same_bits(ref.oets_sort(jnp.asarray(x), num_phases),
               oets.oets_sort(_cpu(x), num_phases))
    perm_r = ref.oets_argsort(jnp.asarray(x), num_phases)
    _same_bits(perm_r, oets.oets_argsort(_cpu(x), num_phases))


def test_oets_kv_is_stable():
    x = np.random.default_rng(0).integers(0, 3, 101).astype(np.int32)
    _, perm = oets.oets_sort_kv(_cpu(x), _cpu(np.arange(101, dtype=np.int32)))
    np.testing.assert_array_equal(to_numpy(perm),
                                  np.argsort(x, kind="stable"))


@pytest.mark.parametrize("lanes", [1, 2, 3])
@pytest.mark.parametrize("n", [1, 64, 77])
def test_multi_lane_uint32_keys_match_reference(lanes, n):
    rng = np.random.default_rng(lanes * 100 + n)
    k = rng.integers(0, 3, (n, lanes)).astype(np.uint32)
    k[::5] = np.iinfo(np.uint32).max
    k[1::7, 0] = np.uint32(0x80000001)       # past 2^31: unsigned order
    _same_bits(ref.oets_sort(jnp.asarray(k)), oets.oets_sort(_cpu(k)))
    _same_bits(ref.oets_argsort(jnp.asarray(k)), oets.oets_argsort(_cpu(k)))
    a, b = k[: n // 2], k[n // 2: 2 * (n // 2)]
    np.testing.assert_array_equal(
        np.asarray(ref.lex_gt(jnp.asarray(a), jnp.asarray(b))),
        to_numpy(oets.lex_gt(_cpu(a), _cpu(b))))


def test_lex_gt_canonical_float_order():
    a = np.array([np.nan, -0.0, 1.0, np.inf], np.float32)
    b = np.array([np.inf, 0.0, np.nan, 1.0], np.float32)
    np.testing.assert_array_equal(
        np.asarray(ref.lex_gt(jnp.asarray(a), jnp.asarray(b))),
        to_numpy(oets.lex_gt(_cpu(a), _cpu(b))))


def test_rejects_signed_multi_lane_keys():
    with pytest.raises(TypeError):
        oets.oets_sort(_cpu(np.zeros((4, 2), np.int32)))


def _bucket_tensor(n_words, seed):
    words = synthetic_words(n_words, seed=seed)
    b = ref_bucketing.bucketize_words(words)
    keys = np.asarray(b.keys).copy()
    keys[0, -1] = np.iinfo(np.uint32).max    # a word equal to the sentinel
    return keys, np.asarray(b.counts)


@pytest.mark.parametrize("algorithm", ["oets", "bitonic", "xla", "pallas"])
def test_sort_buckets_matches_reference(algorithm):
    keys, counts = _bucket_tensor(300, seed=3)
    assert keys.shape[1] <= 128               # one interpreted tile
    want = ref_bucketing.sort_buckets(jnp.asarray(keys), algorithm)
    got = bucketing.sort_buckets(_cpu(keys), algorithm)
    _same_bits(want, got)


def test_sort_buckets_rejects_an_unknown_algorithm():
    with pytest.raises(ValueError):
        bucketing.sort_buckets(_cpu(np.zeros((1, 2, 1), np.uint32)), "nope")


@pytest.mark.parametrize("algorithm", ["oets", "bitonic", "xla"])
def test_bucketed_sort_and_sorted_packed_honour_the_algorithm(algorithm):
    words = synthetic_words(200, seed=7) + ["", "zz", "zz"]
    want = ref_bucketing.bucketed_sort_words(words, algorithm=algorithm)
    assert bucketing.bucketed_sort_words(words, algorithm=algorithm,
                                         device="cpu") == want
    keys = pack_words(words)
    rl, rk = ref_bucketing.sorted_packed(jnp.asarray(keys),
                                         algorithm=algorithm)
    pl, pk = bucketing.sorted_packed(keys, algorithm=algorithm, device="cpu")
    _same_bits(rl, pl)
    _same_bits(rk, pk)
