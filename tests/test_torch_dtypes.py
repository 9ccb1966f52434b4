"""Narrow integer lanes (int8, int16, uint8, uint16) through every front end
of the port's ops, against the reference's ops (Pallas in interpret mode)
bit for bit; and float16/bfloat16, which both packages refuse with
``TypeError``.

The kernels read 32-bit lanes, so the port widens a narrow lane into int32
before a kernel and narrows it back after; these tests hold the round trip
to the reference on inputs that hold each dtype's ``iinfo.max`` (its
padding sentinel) and ``iinfo.min``."""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import lex as rlex
from repro.kernels import ops as rops
from repro.testing.generators import fill_elements
from repro_torch.interop import to_device, to_numpy
from repro_torch.kernels import lex, ops

_NARROW = (np.int8, np.int16, np.uint8, np.uint16)
_N = 96


def _rng(*key) -> np.random.Generator:
    return np.random.default_rng(zlib.crc32("/".join(map(str, key)).encode()))


def _t(a: np.ndarray) -> torch.Tensor:
    return to_device(a, "cpu")


def _lane(gen: str, rng, n: int, dtype) -> np.ndarray:
    x = fill_elements(gen, rng, n, dtype)
    if gen == "sentinel":      # both ends of the range, always
        info = np.iinfo(dtype)
        x[:2] = np.array([info.max, info.min], dtype)[:n]
    return x


def _equal(got, want):
    """Parallel lists of port tensors and reference arrays, bit for bit."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = to_numpy(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def _runs(dtype, sizes, seed):
    """Sorted two-lane runs (lane 0 holding the range's ends) as numpy."""
    rng = _rng("runs", np.dtype(dtype), seed)
    runs = []
    for n in sizes:
        a = _lane("sentinel", rng, n, dtype)
        b = _lane("dup_heavy", rng, n, dtype)
        order = np.lexsort((b, a))
        runs.append((a[order], b[order]))
    return runs


@pytest.mark.parametrize("engine,n", [("oets", _N), ("bitonic", _N),
                                      ("blocksort", 300)])
@pytest.mark.parametrize("dtype", _NARROW)
def test_sort_matches_reference(dtype, engine, n):
    x = _lane("sentinel", _rng("sort", np.dtype(dtype), engine), n, dtype)
    bs = 128 if engine == "blocksort" else None
    got = ops.sort(_t(x), algorithm=engine, block_size=bs)
    want = rops.sort(jnp.asarray(x), algorithm=engine, block_size=bs,
                     interpret=True)
    _equal([got], [want])


@pytest.mark.parametrize("dtype", _NARROW)
def test_sort_kv_matches_reference(dtype):
    rng = _rng("sort_kv", np.dtype(dtype))
    k = _lane("dup_heavy", rng, _N, dtype)
    v = _lane("sentinel", rng, _N, dtype)
    got = ops.sort_kv(_t(k), _t(v))
    want = rops.sort_kv(jnp.asarray(k), jnp.asarray(v), interpret=True)
    _equal(got, want)


@pytest.mark.parametrize("engine", ["lanes", "packed"])
@pytest.mark.parametrize("dtype", _NARROW)
def test_sort_lex_matches_reference(dtype, engine):
    """Two narrow lanes and an int32 payload, two rows; the packed engine
    is what 'auto' picks for them."""
    rng = _rng("sort_lex", np.dtype(dtype), engine)
    lanes = [_lane("sentinel", rng, 2 * _N, dtype).reshape(2, _N),
             _lane("dup_heavy", rng, 2 * _N, dtype).reshape(2, _N)]
    vals = rng.permutation(2 * _N).astype(np.int32).reshape(2, _N)
    assert ops.choose_lex_engine([_t(a).dtype for a in lanes]) == "packed"
    assert rops.choose_lex_engine([a.dtype for a in lanes]) == "packed"
    got, gv = ops.sort_lex([_t(a) for a in lanes], vals=_t(vals),
                           engine=engine)
    want, wv = rops.sort_lex([jnp.asarray(a) for a in lanes],
                             vals=jnp.asarray(vals), engine=engine,
                             interpret=True)
    _equal(list(got) + [gv], list(want) + [wv])


@pytest.mark.parametrize("algorithm", ["oets", "bitonic"])
@pytest.mark.parametrize("dtype", _NARROW)
def test_sort_rows_lex_matches_reference(dtype, algorithm):
    rng = _rng("rows", np.dtype(dtype), algorithm)
    arrs = [_lane("sentinel", rng, 3 * 100, dtype).reshape(3, 100),
            _lane("random", rng, 3 * 100, dtype).reshape(3, 100)]
    got = ops.sort_rows_lex([_t(a) for a in arrs], algorithm=algorithm)
    want = rops.sort_rows_lex([jnp.asarray(a) for a in arrs],
                              algorithm=algorithm, interpret=True)
    _equal(got, want)


@pytest.mark.parametrize("engine", ["lanes", "packed", "kernel", "kway"])
@pytest.mark.parametrize("dtype", _NARROW)
def test_merge_sorted_lex_matches_reference(dtype, engine):
    a, b = _runs(dtype, (150, 170), seed=engine)
    got = ops.merge_sorted_lex(tuple(map(_t, a)), tuple(map(_t, b)),
                               engine=engine, block_size=128)
    want = rops.merge_sorted_lex(tuple(map(jnp.asarray, a)),
                                 tuple(map(jnp.asarray, b)), engine=engine,
                                 block_size=128, interpret=True)
    _equal(got, want)


@pytest.mark.parametrize("engine", ["take", "kernel"])
@pytest.mark.parametrize("dtype", _NARROW)
def test_merge_runs_lex_matches_reference(dtype, engine):
    runs = _runs(dtype, (120, 1, 90), seed=engine)
    got = ops.merge_runs_lex([tuple(map(_t, r)) for r in runs],
                             engine=engine, block_size=128)
    want = rops.merge_runs_lex([tuple(map(jnp.asarray, r)) for r in runs],
                               engine=engine, block_size=128,
                               interpret=True)
    _equal(got, want)


@pytest.mark.parametrize("dtype", _NARROW)
def test_segmented_sort_matches_reference(dtype):
    """Masked slots take the dtype's own sentinel and come back in it."""
    rng = _rng("segmented", np.dtype(dtype))
    keys = _lane("sentinel", rng, 5 * 100 * 2, dtype).reshape(5, 100, 2)
    counts = rng.integers(0, 101, 5).astype(np.int32)
    got = ops.segmented_sort(_t(keys), _t(counts))
    want = rops.segmented_sort(jnp.asarray(keys), jnp.asarray(counts),
                               interpret=True)
    _equal([got], [want])


def _refused_calls(pkg, x, i, interpret):
    """The front ends that take a float16/bfloat16 lane ``x`` beside an
    int32 lane ``i``, each as a thunk."""
    kw = {"interpret": True} if interpret else {}
    return {
        "sort": lambda: pkg.sort(x, **kw),
        "sort_kv_keys": lambda: pkg.sort_kv(x, i, **kw),
        "sort_kv_vals": lambda: pkg.sort_kv(i, x, **kw),
        "sort_lex": lambda: pkg.sort_lex([x, i], **kw),
        "sort_lex_packed": lambda: pkg.sort_lex([x, i], engine="packed",
                                                **kw),
        "sort_rows_lex": lambda: pkg.sort_rows_lex([x[None]], **kw),
        "segmented_sort": lambda: pkg.segmented_sort(x.reshape(1, -1, 1),
                                                     **kw),
        "merge_sorted_lex_lanes": lambda: pkg.merge_sorted_lex(
            (x, i), (x, i), engine="lanes"),
        "merge_sorted_lex_packed": lambda: pkg.merge_sorted_lex(
            (x, i), (x, i), engine="packed"),
        "merge_sorted_lex_kernel": lambda: pkg.merge_sorted_lex(
            (x,), (x,), engine="kernel", **kw),
        "merge_runs_lex_take": lambda: pkg.merge_runs_lex(
            [(x,), (x,)], engine="take"),
        "merge_runs_lex_kernel": lambda: pkg.merge_runs_lex(
            [(x,), (x,)], engine="kernel", **kw),
    }


_HALF = {"float16": (torch.float16, jnp.float16),
         "bfloat16": (torch.bfloat16, jnp.bfloat16)}


@pytest.mark.parametrize("call", sorted(_refused_calls(ops, None, None,
                                                       False)))
@pytest.mark.parametrize("half", sorted(_HALF))
def test_half_floats_raise_type_error_as_in_the_reference(half, call):
    tdt, jdt = _HALF[half]
    vals = np.array([3.0, 1.0, 2.0, -0.5], np.float32)
    idx = np.array([3, 1, 2, 0], np.int32)
    ref = _refused_calls(rops, jnp.asarray(vals).astype(jdt),
                         jnp.asarray(idx), True)[call]
    with pytest.raises(TypeError):
        ref()
    port = _refused_calls(ops, torch.from_numpy(vals).to(tdt),
                          torch.from_numpy(idx), False)[call]
    with pytest.raises(TypeError):
        port()


@pytest.mark.parametrize("half", sorted(_HALF))
def test_half_floats_resolve_to_lanes_and_partition_as_in_the_reference(
        half):
    """Where the reference takes a half float — its lane engine choice,
    its sentinel and ``partition_rows``' int32 cast — the port does too."""
    tdt, jdt = _HALF[half]
    keys = np.array([[3.0, 1.5, -2.5, 7.0]], np.float32)
    spl = np.array([1, 3], np.int32)
    assert ops.choose_lex_engine([tdt, torch.int32]) == "lanes" == \
        rops.choose_lex_engine([jdt, jnp.int32])
    assert torch.isnan(lex.sentinel_for(tdt)) and \
        bool(jnp.isnan(rlex.sentinel_for(jdt)))
    got = ops.partition_rows(torch.from_numpy(keys).to(tdt),
                             torch.from_numpy(spl))
    want = rops.partition_rows(jnp.asarray(keys).astype(jdt),
                               jnp.asarray(spl), interpret=True)
    _equal(got, want)
