"""The port's data substrate (``repro_torch.data``) against the reference's:
bucket plans, the length-bucketed batcher, the prefetching loader, the LM
token stream and the text cleaning, on the same seeded inputs — equal."""

import threading

import numpy as np
import pytest

from repro import data as ref
from repro_torch import data as port


def _lengths(seed, n=500):
    return np.random.default_rng(seed).integers(1, 300, n).tolist()


@pytest.mark.parametrize("n_buckets", [1, 3, 4, 8])
@pytest.mark.parametrize("seed", [0, 1])
def test_plan_buckets_and_padding_waste_equal(n_buckets, seed):
    ls = _lengths(seed)
    bounds = port.plan_buckets(ls, n_buckets)
    assert bounds == ref.plan_buckets(ls, n_buckets)
    assert port.padding_waste(ls, max(ls)) == \
        ref.bucketing.padding_waste(ls, max(ls))


def test_plan_buckets_of_nothing_is_empty():
    assert port.plan_buckets([], 4) == ref.plan_buckets([], 4) == []


def _drain(batcher, items):
    out = []
    for i, seq in items:
        out += batcher.add(i, seq)
    return out + batcher.flush()


@pytest.mark.parametrize("batch_size", [1, 3, 8])
def test_batcher_emits_the_reference_batches(batch_size):
    rng = np.random.default_rng(batch_size)
    items = [(i, rng.integers(0, 50, rng.integers(1, 40)).tolist())
             for i in range(60)]
    bounds = [8, 16, 24, 40]
    want = _drain(ref.LengthBucketedBatcher(bounds, batch_size, 7), items)
    got = _drain(port.LengthBucketedBatcher(bounds, batch_size, 7), items)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["ids"] == w["ids"] and g["bucket_bound"] == w["bucket_bound"]
        np.testing.assert_array_equal(g["tokens"], w["tokens"])
        np.testing.assert_array_equal(g["lengths"], w["lengths"])


def test_batcher_rejects_what_the_reference_rejects():
    with pytest.raises(ValueError):
        port.LengthBucketedBatcher([8, 4], 2)
    b = port.LengthBucketedBatcher([4, 8], 2)
    with pytest.raises(ValueError, match="exceeds largest bucket"):
        b.add(0, [0] * 9)


@pytest.mark.parametrize("seed,shard", [(0, 0), (3, 1)])
def test_token_stream_equals_the_reference(seed, shard):
    kw = dict(vocab_size=1000, batch=3, seq=17, seed=seed, shard_index=shard,
              num_shards=2)
    r, p = ref.TokenStream(**kw), port.TokenStream(**kw)
    for _ in range(3):
        a, b = next(r), next(p)
        for k in ("tokens", "labels"):
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_clean_text_and_words_equal():
    text = "To be, or not to be: that is the question!\nWhether 'tis 42..."
    assert port.clean_text(text) == ref.clean_text(text)
    assert port.words_from_text(text) == ref.words_from_text(text)


def test_synthetic_words_equal():
    assert port.synthetic_words(300, seed=4) == \
        ref.synthetic_words(300, seed=4)


def test_loader_yields_every_item_in_order():
    items = list(range(50))
    want = list(ref.ShardedLoader(iter(items), prefetch=3))
    loader = port.ShardedLoader(iter(items), prefetch=3)
    assert list(loader) == want == items
    loader._thread.join(timeout=10)
    assert not loader._thread.is_alive()


def test_loader_close_stops_the_worker():
    stop = threading.Event()

    def endless():
        i = 0
        while not stop.is_set():
            yield i
            i += 1

    loader = port.ShardedLoader(endless(), prefetch=2)
    assert next(loader) == 0
    loader.close()
    loader._thread.join(timeout=10)
    stop.set()
    assert not loader._thread.is_alive()
