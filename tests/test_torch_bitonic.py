"""The port's bitonic network (``repro_torch.core.bitonic``) against the
reference's (``repro.core.bitonic``), bit for bit: the same network (the
second block reversed behind the first, then XOR stages from ``sub = n``
down), order keys compared and raw bits moved, so ``-0.0``/``+0.0``, NaN
payloads and ``iinfo.max`` land exactly where the reference puts them."""

import jax.numpy as jnp
import numpy as np
import pytest
from jax import lax

from repro.core import bitonic as ref
from repro_torch.core import bitonic as port
from repro_torch.interop import to_device, to_numpy

DTYPES = [np.int32, np.uint32, np.float32, np.int8, np.uint16]
_PAYLOADS = np.array([0x7FC00001, 0xFFC00000, 0x7F800001, 0xFFFFFFFF],
                     np.uint32).view(np.float32)


def _keys(dtype, n, rng, dup=False):
    if dtype == np.float32:
        x = rng.normal(size=n).astype(dtype)
        if dup:
            x = np.round(x).astype(dtype)
        x[::5] = np.float32(-0.0)
        x[1::5] = np.float32(0.0)
        x[2::7] = _PAYLOADS[rng.integers(0, len(_PAYLOADS), x[2::7].size)]
        x[3::11] = np.inf
        return x
    info = np.iinfo(dtype)
    if dup:
        x = rng.integers(0, 3, n).astype(dtype)
    else:
        x = rng.integers(info.min, info.max, n, dtype=dtype, endpoint=True)
    x[::9] = info.max
    return x


def _same_bits(want, got):
    want, got = np.asarray(want), to_numpy(got)
    assert want.dtype == got.dtype and want.shape == got.shape
    np.testing.assert_array_equal(want.view(np.uint8), got.view(np.uint8))


def _cpu(x):
    return to_device(x, "cpu")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [1, 5, 64, 100])
def test_bitonic_sort_and_kv_match_reference(dtype, n):
    rng = np.random.default_rng(n)
    x = _keys(dtype, n, rng, dup=n == 64)
    _same_bits(ref.bitonic_sort(jnp.asarray(x)), port.bitonic_sort(_cpu(x)))
    v = np.arange(n, dtype=np.int32)
    rk, rv = ref.bitonic_sort_kv(jnp.asarray(x), jnp.asarray(v))
    pk, pv = port.bitonic_sort_kv(_cpu(x), _cpu(v))
    _same_bits(rk, pk)
    _same_bits(rv, pv)


def test_bitonic_sort_multi_lane_unsigned_keys():
    rng = np.random.default_rng(3)
    k = rng.integers(0, 5, (37, 3)).astype(np.uint32)
    k[::4] = np.iinfo(np.uint32).max
    _same_bits(ref.bitonic_sort(jnp.asarray(k)), port.bitonic_sort(_cpu(k)))


def _sorted_block(dtype, n, rng):
    # sorted by the canonical order (the reference's own sort), so ±0 and
    # NaN payloads sit where a sorted input holds them
    return np.asarray(ref.bitonic_sort(jnp.asarray(_keys(dtype, n, rng,
                                                         dup=True))))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [1, 2, 8, 64, 256])
def test_bitonic_merges_match_reference(dtype, n):
    rng = np.random.default_rng(100 + n)
    a, b = _sorted_block(dtype, n, rng), _sorted_block(dtype, n, rng)
    _same_bits(ref.bitonic_merge(jnp.asarray(a), jnp.asarray(b)),
               port.bitonic_merge(_cpu(a), _cpu(b)))
    va = np.arange(n, dtype=np.uint32)
    vb = np.arange(n, 2 * n, dtype=np.uint32)
    rk, rv = ref.bitonic_merge_kv(*map(jnp.asarray, (a, va, b, vb)))
    pk, pv = port.bitonic_merge_kv(*map(_cpu, (a, va, b, vb)))
    _same_bits(rk, pk)
    _same_bits(rv, pv)
    # the lex merge: tuples sorted by (key, payload) in each block
    ta = ref.bitonic_sort_kv(jnp.asarray(a), jnp.asarray(va))
    tb = ref.bitonic_sort_kv(jnp.asarray(b), jnp.asarray(vb))
    al, bl = [np.asarray(x) for x in ta], [np.asarray(x) for x in tb]
    want = ref.bitonic_merge_lex([jnp.asarray(x) for x in al],
                                 [jnp.asarray(x) for x in bl])
    got = port.bitonic_merge_lex([_cpu(x) for x in al],
                                 [_cpu(x) for x in bl])
    assert len(got) == 2
    for w, g in zip(want, got):
        _same_bits(w, g)


def test_bitonic_merge_lex_three_mixed_lanes():
    rng = np.random.default_rng(7)
    n = 128

    def block():
        # each block tuple-sorted by XLA's full-tuple sort
        lanes = [rng.integers(0, 3, n).astype(np.uint32),
                 rng.integers(-2, 2, n).astype(np.int32),
                 _keys(np.float32, n, rng, dup=True)]
        return [np.asarray(x) for x in lax.sort(
            [jnp.asarray(x) for x in lanes], num_keys=3)]

    a, b = block(), block()
    want = ref.bitonic_merge_lex([jnp.asarray(x) for x in a],
                                 [jnp.asarray(x) for x in b])
    got = port.bitonic_merge_lex([_cpu(x) for x in a], [_cpu(x) for x in b])
    for w, g in zip(want, got):
        _same_bits(w, g)


@pytest.mark.parametrize("merge", ["merge", "kv", "lex"])
def test_non_power_of_two_blocks_raise(merge):
    x = _cpu(np.arange(6, dtype=np.int32))
    with pytest.raises(ValueError, match="power of two"):
        if merge == "merge":
            port.bitonic_merge(x, x)
        elif merge == "kv":
            port.bitonic_merge_kv(x, x, x, x)
        else:
            port.bitonic_merge_lex([x], [x])
    with pytest.raises(ValueError, match="equal shapes"):
        port.bitonic_merge(_cpu(np.arange(4, dtype=np.int32)),
                           _cpu(np.arange(8, dtype=np.int32)))


def test_sort_of_merged_halves_is_the_sort():
    """Merging two sorted halves gives the sorted whole (the integer
    result is unique)."""
    rng = np.random.default_rng(9)
    x = rng.integers(-100, 100, 512).astype(np.int32)
    a = port.bitonic_sort(_cpu(x[:256]))
    b = port.bitonic_sort(_cpu(x[256:]))
    np.testing.assert_array_equal(to_numpy(port.bitonic_merge(a, b)),
                                  np.sort(x))
