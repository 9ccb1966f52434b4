"""The CUDA kernels against their plain versions on the card.

Every test here carries the ``gpu`` marker and takes the ``cuda`` fixture,
which skips where there is no card; run them on the card with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core import bucketing, packing
from repro_torch.data import synthetic_words
from repro_torch.interop import to_numpy
from repro_torch.kernels import (bitonic_kernel, distribute_kernel, lex,
                                 merge_kernel, oets_kernel)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _stacked(seed, shape, kind):
    rng = np.random.default_rng(seed)
    a, r, c = shape
    if kind == "float":
        f = rng.normal(size=shape).astype(np.float32)
        pick = rng.random(shape)
        f[pick < 0.2] = np.nan
        f[(pick >= 0.2) & (pick < 0.3)] = -0.0
        f[(pick >= 0.3) & (pick < 0.4)] = np.inf
        f[pick >= 0.95] = np.array([0xFFFFFFFF], np.uint32).view(np.float32)
        bits = f.view(np.int32)
        codes = [lex.F32] * a
    else:
        v = rng.integers(0, 4 if kind == "dup" else 1 << 32, shape,
                         dtype=np.uint64)
        v[rng.random(shape) < 0.2] = 0xFFFFFFFF
        bits = v.astype(np.uint32).view(np.int32)
        codes = [lex.U32] * (a - 1) + [lex.I32]
    return torch.from_numpy(np.ascontiguousarray(bits)), codes


@pytest.mark.parametrize("shape", [(4, 17, 128), (5, 3, 256), (1, 1, 128)])
@pytest.mark.parametrize("kind", ["u32", "dup", "float"])
def test_oets_kernel_matches_plain(cuda, shape, kind):
    x, codes = _stacked(1, shape, kind)
    x = x.to(cuda)
    before = oets_kernel.KERNEL.launches
    got = oets_kernel.oets_rows_lex(x.clone(), codes)
    assert oets_kernel.KERNEL.launches == before + 1
    assert torch.equal(got, oets_kernel.oets_rows_lex_plain(x, codes))


@pytest.mark.parametrize("shape", [(4, 17, 1024), (5, 40, 4096),
                                   (9, 2, 2048)])
@pytest.mark.parametrize("kind", ["u32", "dup", "float"])
def test_bitonic_kernel_matches_plain(cuda, shape, kind):
    x, codes = _stacked(2, shape, kind)
    x = x.to(cuda)
    got = bitonic_kernel.bitonic_rows_lex(x.clone(), codes)
    assert torch.equal(got, bitonic_kernel.bitonic_rows_lex_plain(x, codes))


@pytest.mark.parametrize("block,arrays", [(128, 4), (4096, 4), (4096, 5),
                                          (2048, 9)])
def test_merge_kernel_matches_plain(cuda, block, arrays):
    x, codes = _stacked(3, (arrays, 3, 6 * block), "u32")
    x = x.to(cuda)
    bitonic_kernel.bitonic_rows_lex(x.view(arrays, -1, block), codes)
    for lo in (0, block):
        got = merge_kernel.merge_adjacent_lex(x.clone(), codes, block=block,
                                              lo=lo)
        want = x.clone()
        hi = lo + (6 * block - lo) // (2 * block) * 2 * block
        want[..., lo:hi] = merge_kernel.merge_network_plain(
            x[..., lo:hi], codes, block)
        assert torch.equal(got, want)


def test_merge_kernel_refuses_a_window_past_shared_memory(cuda):
    x = torch.zeros((4, 1, 2 * 8192), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        merge_kernel.merge_adjacent_lex(x, [lex.U32] * 4, block=8192)


@pytest.mark.parametrize("n,lanes,pad", [(1, 1, 0), (1023, 4, 0),
                                         (1025, 4, 3), (300_001, 4, 1000),
                                         (70_000, 8, 0)])
def test_distribute_kernel_matches_plain(cuda, n, lanes, pad):
    rng = np.random.default_rng(n)
    raw = rng.integers(0, 1 << 32, (n, lanes), dtype=np.uint64)
    zero = rng.random((n, lanes, 4)) < 0.5           # interior NUL bytes
    for j in range(4):
        raw &= ~(zero[..., j].astype(np.uint64) << (24 - 8 * j))
    keys = torch.from_numpy(raw.astype(np.uint32).view(np.int32)).to(cuda)
    got = distribute_kernel.distribute_rows(keys, n - pad)
    want = distribute_kernel.distribute_rows_plain(keys, n - pad)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_main_path_on_the_card_matches_the_cpu(cuda):
    """10,000 words: capacity past 1024, so blocksort's bitonic and merge
    kernels run, with distribute; bits equal the plain path's."""
    words = synthetic_words(10_000, seed=5)
    keys = packing.pack_words(words)
    got = bucketing.sorted_packed(keys, return_packed=True, device=cuda)
    want = bucketing.sorted_packed(keys, return_packed=True, device="cpu")
    for g, w in zip(got[:2] + got[2], want[:2] + want[2]):
        np.testing.assert_array_equal(to_numpy(g), to_numpy(w))
    assert bucketing.bucketed_sort_words(words, device=cuda) == sorted(
        words, key=lambda w: (len(w.encode()), w.encode()))
