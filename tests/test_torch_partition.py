"""The port's splitter partition (``repro_torch.kernels.ops.partition_rows``,
B7's plain version on the CPU) and its single-block row sorts
(``sort_rows``, ``sort_rows_kv``) against the reference's ops (Pallas in
interpret mode), bit for bit; and the plain version against the port's
``searchsorted`` oracle (``kernels/ref.py``) on sorted splitters."""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as rops
from repro.testing.generators import fill_elements
from repro_torch.interop import to_device, to_numpy
from repro_torch.kernels import (ops, partition_kernel, partition_rows_ref,
                                 sort_rows_kv_ref, sort_rows_ref)


def _rng(*key) -> np.random.Generator:
    return np.random.default_rng(zlib.crc32("/".join(map(str, key)).encode()))


def _check(keys: np.ndarray, spl: np.ndarray):
    """Port against reference, bit for bit; returns the port's result."""
    bid, cnt = ops.partition_rows(to_device(keys, "cpu"),
                                  to_device(spl, "cpu"))
    rbid, rcnt = rops.partition_rows(jnp.asarray(keys), jnp.asarray(spl),
                                     interpret=True)
    bid, cnt = to_numpy(bid), to_numpy(cnt)
    for g, w in ((bid, rbid), (cnt, rcnt)):
        w = np.asarray(w)
        assert g.dtype == w.dtype == np.int32 and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    assert (cnt >= 0).all() and (cnt.sum(axis=1) == keys.shape[1]).all()
    return bid, cnt


def _sorted_splitters(rng, n, high=10_000):
    return np.sort(rng.choice(high, n, replace=False)).astype(np.int32)


# every shape and splitter count of tests/test_kernels.py, 200 splitters,
# and the 127-splitter tile bound of tests/test_partition_edges.py
@pytest.mark.parametrize("shape,n_spl", [((4, 64), 7), ((8, 128), 15),
                                         ((3, 200), 3), ((5, 96), 31),
                                         ((3, 128), 1), ((3, 128), 127),
                                         ((3, 300), 200)])
def test_partition_rows_matches_reference(shape, n_spl):
    rng = _rng("partition", shape, n_spl)
    keys = rng.integers(0, 10_000, shape).astype(np.int32)
    _check(keys, _sorted_splitters(rng, n_spl))


def test_zero_splitters_single_bucket():
    keys = _rng("zero").integers(-100, 100, (3, 130)).astype(np.int32)
    bid, cnt = _check(keys, np.zeros(0, np.int32))
    assert (bid == 0).all() and (cnt[:, 0] == 130).all()


def test_key_equal_to_a_splitter_goes_right():
    bid, cnt = _check(np.full((2, 96), 50, np.int32),
                      np.array([10, 50, 90], np.int32))
    assert (bid == 2).all() and (cnt[:, 2] == 96).all()
    bid, cnt = _check(np.array([[42]], np.int32), np.array([42], np.int32))
    assert bid[0, 0] == 1 and cnt[0].tolist() == [0, 1]


@pytest.mark.parametrize("shape,low,high", [((4, 128), 0, 1000),
                                            ((5, 130), 900, 1000),
                                            ((5, 130), 0, 100),
                                            ((1, 130), -50, 50)])
def test_lane_boundaries_and_padding(shape, low, high):
    """cols at the 128-lane tile, one past it with every key above the
    splitters (the reference's top-bucket correction), padded rows, one
    row: the port pads nothing, so each is an ordinary case."""
    keys = _rng("pad", shape, low).integers(low, high, shape).astype(
        np.int32)
    _check(keys, np.array([25, 50, 75, 250, 500, 750], np.int32))


def test_int32_extremes():
    """Keys at INT32_MIN and INT32_MAX against splitters at both ends."""
    info = np.iinfo(np.int32)
    keys = _rng("extremes").integers(-5, 5, (3, 150)).astype(np.int32)
    keys[:, ::3] = info.max
    keys[:, 1::3] = info.min
    _check(keys, np.array([info.min, -1, 0, info.max], np.int32))


@pytest.mark.parametrize("kind", ["unsorted", "duplicated"])
def test_unsorted_and_duplicated_splitters(kind):
    """The id is a count of splitters at or below the key, as the TPU
    kernel computes it, not a binary search."""
    rng = _rng(kind)
    keys = rng.integers(0, 100, (4, 140)).astype(np.int32)
    if kind == "unsorted":
        spl = rng.permutation(np.arange(5, 100, 7)).astype(np.int32)
    else:
        spl = np.array([10, 10, 10, 40, 40, 90], np.int32)
    bid, _ = _check(keys, spl)
    np.testing.assert_array_equal(
        bid, (keys[..., None] >= spl).sum(-1).astype(np.int32))


@pytest.mark.parametrize("perm", range(3))
@pytest.mark.parametrize("n_spl", [1, 9, 200])
def test_ids_do_not_depend_on_splitter_order(n_spl, perm):
    """The invariant the kernel's sorted-splitter search rests on: every
    permutation of an unsorted, duplicated splitter list gives the same ids
    and counts in the reference and the port, and those are the upper
    bounds over the splitters sorted (``searchsorted(side='right')``)."""
    rng = _rng("order", n_spl)
    spl = rng.integers(-50, 50, n_spl).astype(np.int32)
    spl[rng.integers(0, n_spl, n_spl // 3)] = spl[0]      # duplicates
    keys = rng.integers(-60, 60, (3, 130)).astype(np.int32)
    keys[:, ::4] = spl[rng.integers(0, n_spl, keys[:, ::4].shape)]
    spl = _rng("order", n_spl, perm).permutation(spl)
    bid, cnt = _check(keys, spl)
    want = np.searchsorted(np.sort(spl), keys, side="right")
    np.testing.assert_array_equal(bid, want)
    np.testing.assert_array_equal(
        cnt, np.stack([np.bincount(r, minlength=n_spl + 1) for r in want]))


def test_uint32_keys_wrap_to_int32():
    """uint32 keys at or above 2^31 wrap, as ``astype(jnp.int32)`` casts:
    3,000,000,000 lands below splitter 2."""
    keys = np.array([[3_000_000_000, 1, 2, 5, 0xFFFFFFFF, 1 << 31]],
                    np.uint32)
    bid, _ = _check(keys, np.array([2], np.int32))
    assert bid[0].tolist() == [0, 0, 1, 1, 0, 0]
    rng = _rng("u32")
    keys = rng.integers(0, 1 << 32, (3, 100), dtype=np.uint64).astype(
        np.uint32)
    _check(keys, np.sort(rng.integers(-(1 << 31), 1 << 31, 9)).astype(
        np.int32))


@pytest.mark.parametrize("dtype", [np.int8, np.int16, np.uint8, np.uint16])
def test_narrow_keys_widen(dtype):
    keys = fill_elements("sentinel", _rng("narrow", np.dtype(dtype)), 300,
                         dtype).reshape(2, 150)
    _check(keys, np.array([-100, 0, 3, 50, 99, 127, 1000], np.int32))


def test_float_keys_truncate_toward_zero():
    """Finite float keys cast as ``astype(jnp.int32)``: 1.7 lands in the
    bucket of 1, -0.5 in that of 0."""
    keys = np.array([[1.7, 0.2, -0.5, -1.2, 3.999, 2.0]], np.float32)
    bid, _ = _check(keys, np.array([-1, 0, 1, 2, 3], np.int32))
    assert bid[0].tolist() == [3, 2, 2, 1, 5, 4]
    keys = _rng("float").normal(scale=50.0, size=(3, 130)).astype(np.float32)
    _check(keys, np.array([-40, -5, 0, 5, 40], np.int32))


@pytest.mark.parametrize("shape,n_spl", [((4, 64), 7), ((3, 300), 200),
                                         ((2, 130), 0), ((1, 1), 1)])
def test_plain_matches_searchsorted_oracle(shape, n_spl):
    rng = _rng("oracle", shape, n_spl)
    keys = torch.from_numpy(rng.integers(0, 10_000, shape).astype(np.int32))
    spl = torch.from_numpy(_sorted_splitters(rng, n_spl))
    got = partition_kernel.partition_rows_plain(keys, spl)
    want = partition_rows_ref(keys, spl)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == torch.int32
        assert torch.equal(g, w)


def test_too_many_splitters_raise():
    n = partition_kernel.MAX_SPLITTERS + 1
    with pytest.raises(ValueError, match="splitters"):
        ops.partition_rows(torch.zeros((1, 4), dtype=torch.int32),
                           torch.zeros(n, dtype=torch.int32))


@pytest.mark.parametrize("algorithm", ["oets", "bitonic"])
@pytest.mark.parametrize("dtype,shape", [(np.int32, (6, 96)),
                                         (np.uint32, (3, 200)),
                                         (np.float32, (2, 129)),
                                         (np.int16, (4, 100))])
def test_sort_rows_matches_reference(dtype, shape, algorithm):
    gen = "nan" if dtype == np.float32 else "sentinel"
    rng = _rng("sort_rows", np.dtype(dtype), algorithm)
    x = fill_elements(gen, rng, shape[0] * shape[1], dtype).reshape(shape)
    got = to_numpy(ops.sort_rows(to_device(x, "cpu"), algorithm=algorithm))
    want = np.asarray(rops.sort_rows(jnp.asarray(x), algorithm=algorithm,
                                     interpret=True))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got.view(f"u{got.itemsize}"),
                                  want.view(f"u{want.itemsize}"))
    if dtype != np.float32:
        np.testing.assert_array_equal(
            got, to_numpy(sort_rows_ref(to_device(x, "cpu"))))


@pytest.mark.parametrize("algorithm", ["oets", "bitonic"])
@pytest.mark.parametrize("kdtype,vdtype", [(np.int32, np.int32),
                                           (np.uint32, np.float32),
                                           (np.int8, np.uint16)])
def test_sort_rows_kv_matches_reference(kdtype, vdtype, algorithm):
    rng = _rng("sort_rows_kv", np.dtype(kdtype), algorithm)
    keys = fill_elements("dup_heavy", rng, 3 * 120, kdtype).reshape(3, 120)
    vals = fill_elements("random", rng, 3 * 120, vdtype).reshape(3, 120)
    gk, gv = ops.sort_rows_kv(to_device(keys, "cpu"), to_device(vals, "cpu"),
                              algorithm=algorithm)
    wk, wv = rops.sort_rows_kv(jnp.asarray(keys), jnp.asarray(vals),
                               algorithm=algorithm, interpret=True)
    for g, w in ((gk, wk), (gv, wv)):
        g, w = to_numpy(g), np.asarray(w)
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g.view(f"u{g.itemsize}"),
                                      w.view(f"u{w.itemsize}"))
    if kdtype == vdtype == np.int32:   # the oracle's stable order, on keys
        rk, _ = sort_rows_kv_ref(torch.from_numpy(keys),
                                 torch.from_numpy(vals))
        np.testing.assert_array_equal(to_numpy(gk), rk.numpy())
    with pytest.raises(ValueError):
        ops.sort_rows_kv(to_device(keys, "cpu"), to_device(vals[:, 1:],
                                                           "cpu"))
