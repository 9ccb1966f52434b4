"""The port's key plane (``repro_torch.kernels.lex``) against the reference
(``repro.kernels.lex``): order bits bit for bit, their inverse, the
sentinels and the lexicographic compare, on the adversarial generators."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import lex as rlex
from repro.testing.generators import fill_elements
from repro_torch.kernels import lex

_SPECIALS = np.array([0x00000000, 0x80000000, 0x7F800000, 0xFF800000,
                      0x7FC00000, 0x7FC00001, 0xFFC00000, 0x7F800001,
                      0xFFFFFFFF, 0x3F800000, 0xBF800000],
                     np.uint32).view(np.float32)


_NARROW = {torch.int8: np.int8, torch.int16: np.int16, torch.uint8: np.uint8,
           torch.uint16: np.uint16}


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int32).numpy().view(np.uint32)


def _lane(gen: str, dtype, seed: int) -> np.ndarray:
    x = fill_elements(gen, np.random.default_rng(seed), 96, dtype)
    if dtype == np.float32:
        x = np.concatenate([x, _SPECIALS])
    return x


@pytest.mark.parametrize("gen,dtype", [
    ("nan", np.float32), ("sentinel", np.float32), ("dup_heavy", np.float32),
    ("random", np.int32), ("sentinel", np.int32), ("random", np.uint32),
    ("sentinel", np.uint32)])
def test_order_bits_match_reference(gen, dtype):
    x = _lane(gen, dtype, seed=11)
    got = lex.to_order_bits(torch.from_numpy(x))
    assert got.dtype == torch.uint32
    want = np.asarray(rlex.to_order_bits(jnp.asarray(x)))
    np.testing.assert_array_equal(_bits(got), want)
    back = lex.from_order_bits(got, torch.from_numpy(x).dtype)
    want_back = np.asarray(rlex.from_order_bits(jnp.asarray(want), x.dtype))
    np.testing.assert_array_equal(back.numpy().view(np.uint32),
                                  want_back.view(np.uint32))


def test_order_bits_float_contract():
    """Every NaN above +inf, the all-ones sentinel strictly highest, and
    -0.0 == +0.0."""
    ob = _bits(lex.to_order_bits(torch.from_numpy(_SPECIALS)))
    pos_inf = ob[2]
    nan_slots = ob[4:9]
    assert (nan_slots > pos_inf).all()
    assert ob[8] == 0xFFFFFFFF and (ob[4:8] == 0xFFFFFFFE).all()
    assert ob[0] == ob[1]


def test_bounded_lane_passes_through():
    x = np.array([0, 5, 17, 3], np.int32)
    got = lex.to_order_bits(torch.from_numpy(x), max_value=17)
    np.testing.assert_array_equal(
        _bits(got), np.asarray(rlex.to_order_bits(jnp.asarray(x), 17)))
    with pytest.raises(TypeError):
        lex.to_order_bits(torch.zeros(2, dtype=torch.float32), max_value=1)


@pytest.mark.parametrize("dtype", [torch.uint32, torch.int32, torch.float32])
def test_sentinel_for_matches_reference(dtype):
    np_dtype = {torch.uint32: np.uint32, torch.int32: np.int32,
                torch.float32: np.float32}[dtype]
    got = lex.sentinel_for(dtype)
    assert got.dtype == dtype
    want = np.asarray(rlex.sentinel_for(np_dtype))
    assert got.view(torch.int32).item() == int(want.view(np.int32))


@pytest.mark.parametrize("dtype", list(_NARROW), ids=str)
def test_narrow_sentinel_for_matches_reference(dtype):
    got = lex.sentinel_for(dtype)
    assert got.dtype == dtype
    want = np.asarray(rlex.sentinel_for(_NARROW[dtype]))
    assert int(lex.as_bits(got)) == int(want) == lex.pad_bits(dtype)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lex_gt_lanes_matches_reference(seed):
    """A float32 NaN lane, a duplicate-heavy int32 lane and a
    sentinel-colliding uint32 lane, compared against a shuffled copy."""
    rng = np.random.default_rng(seed)
    lanes = [fill_elements("nan", rng, 96, np.float32),
             fill_elements("dup_heavy", rng, 96, np.int32),
             fill_elements("sentinel", rng, 96, np.uint32)]
    perm = rng.permutation(96)
    other = [a[perm] for a in lanes]
    other[0][:10] = lanes[0][:10]          # force ties on the leading lane
    got = lex.lex_gt_lanes([torch.from_numpy(a) for a in lanes],
                           [torch.from_numpy(b) for b in other])
    want = rlex.lex_gt_lanes([jnp.asarray(a) for a in lanes],
                             [jnp.asarray(b) for b in other])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_order_view_orders_like_order_bits():
    x = torch.from_numpy(_lane("nan", np.float32, seed=5))
    ov = lex.order_view(x)
    ob = lex.to_order_bits(x).view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    assert torch.equal(ov[:, None] > ov[None, :], ob[:, None] > ob[None, :])


def test_narrow_lanes_wait_for_a2():
    """Narrow integer lanes are taken, as in the reference: they widen into
    int32 lanes under the I32 code, keep their values through the round
    trip, and their order bits are the reference's (a shift by
    2^(bits-1), not the 32-bit sign flip)."""
    x = np.array([5, -3, 127, -128, 0, 7], np.int16)
    t = torch.from_numpy(x)
    assert lex.dtype_code(torch.int16) == lex.I32
    bits = lex.as_bits(t)
    assert bits.dtype == torch.int32
    np.testing.assert_array_equal(bits.numpy(), x.astype(np.int32))
    assert torch.equal(lex.from_bits(bits, torch.int16), t)
    np.testing.assert_array_equal(
        _bits(lex.to_order_bits(t)), np.asarray(rlex.to_order_bits(
            jnp.asarray(x))))
    for dtype in (torch.float16, torch.bfloat16, torch.int64):
        with pytest.raises(TypeError):
            lex.dtype_code(dtype)



@pytest.mark.parametrize("gen", ["random", "sentinel", "dup_heavy"])
@pytest.mark.parametrize("dtype", list(_NARROW), ids=str)
def test_narrow_order_bits_match_reference(dtype, gen):
    x = _lane(gen, _NARROW[dtype], seed=13)
    got = lex.to_order_bits(torch.from_numpy(x))
    want = np.asarray(rlex.to_order_bits(jnp.asarray(x)))
    np.testing.assert_array_equal(_bits(got), want)
    back = lex.from_order_bits(got, dtype)
    assert back.dtype == dtype
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(rlex.from_order_bits(jnp.asarray(want),
                                                      x.dtype)))
    np.testing.assert_array_equal(back.numpy(), x)
    bound = np.abs(x.astype(np.int64)).max()
    got = lex.to_order_bits(torch.from_numpy(np.abs(x)), max_value=bound)
    np.testing.assert_array_equal(
        _bits(got), np.asarray(rlex.to_order_bits(jnp.asarray(np.abs(x)),
                                                  bound)))


def test_map_and_select_lanes_match_reference():
    rng = np.random.default_rng(4)
    lanes = [rng.integers(-9, 9, 12).astype(np.int32) for _ in range(3)]
    other = [rng.integers(-9, 9, 12).astype(np.int32) for _ in range(3)]
    mask = rng.random(12) < 0.5
    tl = [torch.from_numpy(a) for a in lanes]
    got = lex.select_lanes(torch.from_numpy(mask),
                           lex.map_lanes(lambda a: torch.roll(a, 1), tl),
                           [torch.from_numpy(b) for b in other])
    want = rlex.select_lanes(jnp.asarray(mask),
                             rlex.map_lanes(lambda a: jnp.roll(a, 1),
                                            [jnp.asarray(a) for a in lanes]),
                             [jnp.asarray(b) for b in other])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
