"""The port's ops (``repro_torch.kernels.ops``) against the reference's
(``repro.kernels.ops``, Pallas in interpret mode) over the adversarial
generators, with the reference's own check per generator: bit identity,
and for ``nan`` the total order (the output is a bit-level permutation of
the reference's and sorted under the canonical order bits)."""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.packing import pack_words
from repro.kernels import ops as rops
from repro.pipeline.validate import check_lanes_sorted
from repro.runtime.failure import CapacityOverflow as RefOverflow
from repro.testing.generators import (ADVERSARIAL, check_mode, default_n,
                                      fill_elements, make_words)
from repro_torch.interop import to_device, to_numpy
from repro_torch.kernels import ops
from repro_torch.runtime import CapacityOverflow

_BLOCK = 128
_SORT_DTYPES = {"random": (np.int32, np.float32),
                "dup_heavy": (np.int32, np.float32),
                "sentinel": (np.int32, np.uint32, np.float32),
                "nan": (np.float32,)}
_CASES = [(g, dt) for g in ADVERSARIAL
          for dt in _SORT_DTYPES.get(g, (np.int32,))]


def _t(a: np.ndarray) -> torch.Tensor:
    return to_device(a, "cpu")


def _assert_conforms(gen, got, want):
    """``got``/``want``: parallel lists of numpy lanes."""
    got = [np.asarray(g) for g in got]
    want = [np.asarray(w) for w in want]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
    if check_mode(gen) == "exact":
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.view(np.uint32), w.view(np.uint32))
        return
    # total order, row by row: the same tuples bit for bit, and sorted
    got = [g.reshape(-1, g.shape[-1]) for g in got]
    want = [w.reshape(-1, w.shape[-1]) for w in want]
    for r in range(got[0].shape[0]):
        tuples = lambda ls: sorted(zip(*[l[r].view(np.uint32).tolist()
                                         for l in ls]))
        assert tuples(got) == tuples(want)
        check_lanes_sorted([g[r] for g in got], what="port output")


@pytest.mark.parametrize("engine", ["oets", "bitonic", "blocksort"])
@pytest.mark.parametrize("gen,dtype", _CASES)
def test_sort_matches_reference(gen, dtype, engine):
    rng = np.random.default_rng(zlib.crc32(f"{gen}/{np.dtype(dtype)}".encode()))
    x = fill_elements(gen, rng, default_n(gen), dtype)
    bs = _BLOCK if engine == "blocksort" else None
    got = ops.sort(_t(x), algorithm=engine, block_size=bs)
    want = rops.sort(jnp.asarray(x), algorithm=engine, block_size=bs,
                     interpret=True)
    _assert_conforms(gen, [to_numpy(got)], [want])


@pytest.mark.parametrize("gen,dtype", _CASES)
def test_sort_kv_matches_reference(gen, dtype):
    rng = np.random.default_rng(3)
    n = default_n(gen)
    k = fill_elements(gen, rng, n, dtype)
    v = rng.permutation(n).astype(np.int32)
    gk, gv = ops.sort_kv(_t(k), _t(v))
    wk, wv = rops.sort_kv(jnp.asarray(k), jnp.asarray(v), interpret=True)
    _assert_conforms(gen, [to_numpy(gk), to_numpy(gv)], [wk, wv])


@pytest.mark.parametrize("gen", ["random", "dup_heavy", "sentinel", "nan",
                                 "tile_boundary"])
def test_sort_lex_lanes_matches_reference(gen):
    """Three mixed 32-bit lanes and a payload, two rows."""
    rng = np.random.default_rng(5)
    n = default_n(gen)
    lane0 = np.float32 if gen == "nan" else np.uint32
    lanes = [fill_elements(gen, rng, 2 * n, lane0).reshape(2, n),
             fill_elements("dup_heavy", rng, 2 * n, np.int32).reshape(2, n),
             fill_elements(gen, rng, 2 * n, np.uint32).reshape(2, n)]
    vals = rng.permutation(2 * n).astype(np.int32).reshape(2, n)
    got, gv = ops.sort_lex([_t(a) for a in lanes], vals=_t(vals),
                           engine="lanes")
    want, wv = rops.sort_lex([jnp.asarray(a) for a in lanes],
                             vals=jnp.asarray(vals), engine="lanes",
                             interpret=True)
    _assert_conforms(gen, [to_numpy(g) for g in got] + [to_numpy(gv)],
                     list(want) + [wv])


def test_sort_lex_packed_engine_waits_for_a6():
    """The packed engine, which 'auto' picks when the tuple packs
    losslessly into fewer lanes, sorts as the reference's does; full uint32
    word lanes never pack losslessly and stay on 'lanes'."""
    lanes = [np.array([3, 1, 2, 1, 7], np.int32),
             np.array([0, 7, 5, 2, 7], np.int32)]
    assert ops.choose_lex_engine([torch.int32] * 2, (7, 7)) == "packed"
    got = ops.sort_lex([_t(a) for a in lanes], max_values=(7, 7))
    want = rops.sort_lex([jnp.asarray(a) for a in lanes], max_values=(7, 7),
                         interpret=True)
    _assert_conforms("random", [to_numpy(g) for g in got], list(want))
    words = [torch.tensor([1, 2], dtype=torch.uint32)] * 4
    assert ops.choose_lex_engine([w.dtype for w in words]) == "lanes"


@pytest.mark.parametrize("engine", ["auto", "packed"])
@pytest.mark.parametrize("gen", ["random", "dup_heavy", "tile_boundary",
                                 "empty"])
def test_sort_lex_packed_integer_lanes_match_reference(gen, engine):
    """Bounded int32 and uint32 lanes that pack into one rank-key lane,
    with a payload, 1-D; 'auto' resolves to 'packed'."""
    rng = np.random.default_rng(zlib.crc32(gen.encode()))
    n = default_n(gen)
    bounds = (1023, 1023, 255)
    lanes = [rng.integers(0, b + 1, n).astype(dt)
             for b, dt in zip(bounds, (np.int32, np.uint32, np.int32))]
    vals = rng.permutation(n).astype(np.int32)
    assert ops.choose_lex_engine([_t(a).dtype for a in lanes], bounds,
                                 engine) == "packed"
    got, gv = ops.sort_lex([_t(a) for a in lanes], vals=_t(vals),
                           engine=engine, max_values=bounds)
    want, wv = rops.sort_lex([jnp.asarray(a) for a in lanes],
                             vals=jnp.asarray(vals), engine=engine,
                             max_values=bounds, interpret=True)
    _assert_conforms(gen, [to_numpy(g) for g in got] + [to_numpy(gv)],
                     list(want) + [wv])


@pytest.mark.parametrize("algorithm", ["oets", "bitonic", "blocksort"])
@pytest.mark.parametrize("gen", ["nan", "sentinel", "dup_heavy"])
def test_sort_lex_packed_float_lanes_match_reference(gen, algorithm):
    """A float32 lane and two bounded int32 lanes, which 'auto' packs into
    two rank-key lanes, two rows and a payload: sorted by (rank keys, iota) and the originals
    gathered, so every NaN payload and -0.0 survives — held to the
    reference's contract: the same tuples bit for bit, sorted under the
    order bits."""
    rng = np.random.default_rng(zlib.crc32(f"{gen}/{algorithm}".encode()))
    n = 300 if algorithm == "blocksort" else default_n(gen)
    lanes = [fill_elements(gen, rng, 2 * n, np.float32).reshape(2, n),
             rng.integers(0, 8, (2, n)).astype(np.int32),
             rng.integers(0, 4, (2, n)).astype(np.int32)]
    bounds = (None, 7, 3)
    vals = rng.permutation(2 * n).astype(np.int32).reshape(2, n)
    bs = _BLOCK if algorithm == "blocksort" else None
    assert ops.choose_lex_engine([torch.float32, torch.int32, torch.int32],
                                 bounds) == "packed"
    got, gv = ops.sort_lex([_t(a) for a in lanes], vals=_t(vals),
                           algorithm=algorithm, block_size=bs,
                           max_values=bounds)
    want, wv = rops.sort_lex([jnp.asarray(a) for a in lanes],
                             vals=jnp.asarray(vals), algorithm=algorithm,
                             block_size=bs, max_values=bounds,
                             interpret=True)
    got = [to_numpy(g) for g in got]
    for r in range(2):
        check_lanes_sorted([g[r] for g in got], what="port output")
        tuples = lambda ls: sorted(zip(*[l[r].view(np.uint32).tolist()
                                         for l in ls]))
        assert tuples(got + [to_numpy(gv)]) == tuples(lanes + [vals])
    # the iota tie-break makes the permutation unique, so the gathered
    # lanes are also the reference's bit for bit
    _assert_conforms("random", got + [to_numpy(gv)], list(want) + [wv])


@pytest.mark.parametrize("cols,algorithm", [(1, "auto"), (128, "auto"),
                                            (129, "auto"), (1024, "auto"),
                                            (1025, "auto"), (5000, "auto"),
                                            (300, "oets")])
def test_choose_plan_matches_reference(cols, algorithm):
    assert ops.choose_plan(cols, algorithm) == rops.choose_plan(cols,
                                                                algorithm)


@pytest.mark.parametrize("cap,algorithm,block", [(100, "auto", None),
                                                 (200, "auto", None),
                                                 (300, "blocksort", 128)])
def test_segmented_sort_matches_reference(cap, algorithm, block):
    rng = np.random.default_rng(cap)
    keys = rng.integers(0, 1 << 32, (17, cap, 4), dtype=np.uint64)
    keys[rng.random(keys.shape) < 0.2] = 0xFFFFFFFF      # sentinel collisions
    keys[:, : cap // 3, 0] = 7                             # ties on lane 0
    keys = keys.astype(np.uint32)
    counts = rng.integers(0, cap + 1, 17).astype(np.int32)
    got = ops.segmented_sort(_t(keys), _t(counts), algorithm=algorithm,
                             block_size=block)
    want = rops.segmented_sort(jnp.asarray(keys), jnp.asarray(counts),
                               algorithm=algorithm, block_size=block,
                               interpret=True)
    np.testing.assert_array_equal(to_numpy(got), np.asarray(want))


def _word_keys(gen: str, max_len: int = 8) -> np.ndarray:
    words = make_words(gen, np.random.default_rng(9), max_len=max_len)
    return pack_words(words, width=max_len)


@pytest.mark.parametrize("gen", [g for g in ADVERSARIAL if g != "nan"])
def test_bucketize_matches_reference(gen):
    keys = _word_keys(gen)
    gd, gr, gc = ops.distribute(_t(keys))
    wd, wr, wc = rops.distribute(jnp.asarray(keys), interpret=True)
    for g, w in ((gd, wd), (gr, wr), (gc, wc)):
        np.testing.assert_array_equal(to_numpy(g), np.asarray(w))
    got = ops.bucketize(_t(keys))
    want = rops.bucketize(jnp.asarray(keys), interpret=True)
    np.testing.assert_array_equal(to_numpy(got.buckets),
                                  np.asarray(want.buckets))
    np.testing.assert_array_equal(to_numpy(got.counts),
                                  np.asarray(want.counts))
    assert got.dropped == want.dropped == 0


@pytest.mark.parametrize("policy", ["clip", "retry", "raise"])
def test_bucketize_overflow_policies_match_reference(policy):
    keys = _word_keys("skewed")
    capacity = 8
    if policy == "raise":
        with pytest.raises(CapacityOverflow) as got:
            ops.bucketize(_t(keys), capacity=capacity, on_overflow=policy)
        with pytest.raises(RefOverflow) as want:
            rops.bucketize(jnp.asarray(keys), capacity=capacity,
                           on_overflow=policy, interpret=True)
        for field in ("capacity", "required", "dropped"):
            assert getattr(got.value, field) == getattr(want.value, field)
        assert isinstance(got.value, ValueError)
        return
    got = ops.bucketize(_t(keys), capacity=capacity, on_overflow=policy)
    want = rops.bucketize(jnp.asarray(keys), capacity=capacity,
                          on_overflow=policy, interpret=True)
    np.testing.assert_array_equal(to_numpy(got.buckets),
                                  np.asarray(want.buckets))
    np.testing.assert_array_equal(to_numpy(got.counts),
                                  np.asarray(want.counts))
    assert got.dropped == want.dropped
    assert (got.dropped > 0) == (policy == "clip")


def test_bucketize_autotune_retries_a_skewed_spread():
    """One dominant length overflows the optimistic capacity; the exact
    count retry keeps every word."""
    keys = _word_keys("skewed")
    n, lanes = keys.shape
    assert ops._optimistic_capacity(n, 4 * lanes + 1) == \
        rops._optimistic_capacity(n, 4 * lanes + 1)
    got = ops.bucketize(_t(keys))
    assert got.buckets.shape[1] == int(got.counts.max()) > \
        ops._optimistic_capacity(n, 4 * lanes + 1)


def test_execution_provenance_on_the_cpu():
    prov = ops.execution_provenance("cpu")
    assert prov["backend"] == "cpu" and prov["kernels"] == "plain-torch"
    assert prov["torch"] == torch.__version__
    assert prov["compute_capability"] is None
