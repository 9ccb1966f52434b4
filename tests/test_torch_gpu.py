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
from repro_torch.kernels import (adversarial, bitonic_kernel,
                                 distribute_kernel, kway_kernel, lex,
                                 merge_kernel, oets_kernel, ops,
                                 partition_kernel, runmerge_kernel)
from repro_torch.kernels.keypack import packed_cmp_lanes
from repro_torch.pipeline import chunked_sort_words
from repro_torch.pipeline.validate import order_bits_view

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


def _sorted_runs(seed, sizes, kind):
    """Sorted runs of ``kind`` on the CPU, and the compare-lane count to
    merge them with: 'u32' (three uint32 lanes, a fifth of them the
    sentinel), 'dup' (three lanes in [0, 4): equal tuples across runs),
    'float' (a float32 lane of NaNs, ±0 and ±inf and an int32 payload,
    compared through its packing) or 'wide' (the shortlex tuple of 32-byte
    words behind its 9 compare lanes: 18 arrays)."""
    rng = np.random.default_rng(seed)
    if kind == "wide":
        runs = []
        for n in sizes:
            ws = ["".join(rng.choice(list("abc"), int(ln)))
                  for ln in rng.integers(1, 33, n)]
            ws = sorted(ws, key=lambda w: (len(w.encode()), w.encode()))
            keys = packing.pack_words(ws, width=32)
            lanes = [torch.tensor([len(w.encode()) for w in ws],
                                  dtype=torch.int32)]
            lanes += [torch.from_numpy(keys[:, l].view(np.int32).copy()).view(
                torch.uint32) for l in range(8)]
            runs.append(tuple(packed_cmp_lanes(
                lanes, (32,) + (None,) * 8)) + tuple(lanes))
        return runs, 9
    runs = []
    for n in sizes:
        if kind == "float":
            f = rng.normal(size=n).astype(np.float32)
            pick = rng.random(n)
            f[pick < 0.2] = np.nan
            f[(pick >= 0.2) & (pick < 0.35)] = -0.0
            f[(pick >= 0.35) & (pick < 0.5)] = 0.0
            f[(pick >= 0.5) & (pick < 0.55)] = np.inf
            f[pick >= 0.95] = np.array([0xFFFFFFFF], np.uint32).view(
                np.float32)
            lanes = [f.view(np.uint32),
                     rng.integers(-3, 3, n).astype(np.int32).view(np.uint32)]
            order = np.lexsort((lanes[1].view(np.int32),
                                order_bits_view(f)))
            runs.append((torch.from_numpy(f[order].copy()),
                         torch.from_numpy(lanes[1][order].view(np.int32))))
            continue
        v = rng.integers(0, 4 if kind == "dup" else 1 << 32, (3, n),
                         dtype=np.uint64).astype(np.uint32)
        if kind == "u32":
            v[rng.random((3, n)) < 0.2] = 0xFFFFFFFF
        order = np.lexsort(v[::-1])
        runs.append(tuple(torch.from_numpy(
            np.ascontiguousarray(l[order]).view(np.int32)).view(torch.uint32)
            for l in v))
    return runs, (None if kind == "float" else 3)


def _to(runs, dev):
    return [tuple(lex.as_bits(x).to(dev).view(x.dtype) if x.dtype ==
                  torch.uint32 else x.to(dev) for x in r) for r in runs]


def _same_bits(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(lex.as_bits(g).cpu(), lex.as_bits(w).cpu())


_RUN_CASES = [("u32", (3000, 2500)), ("dup", (1000, 1700)),
              ("float", (700, 900)), ("wide", (600, 500)),
              ("u32", (1, 900)), ("dup", (255, 1))]


@pytest.mark.parametrize("kind,sizes", _RUN_CASES)
def test_runmerge_kernel_matches_plain(cuda, kind, sizes):
    runs, n_cmp = _sorted_runs(4, sizes, kind)
    a, b = _to(runs, cuda)
    before = runmerge_kernel.KERNEL.launches
    got = runmerge_kernel.merge_runs_lex_kernel(a, b, n_cmp=n_cmp)
    assert runmerge_kernel.KERNEL.launches == before + 1
    want = runmerge_kernel.merge_runs_lex_kernel(*runs, n_cmp=n_cmp)
    _same_bits(got, want)


@pytest.mark.parametrize("kind,sizes", _RUN_CASES[:4] + [
    ("u32", (4096,) * 57), ("dup", (0, 1, 0, 300, 1, 4096, 0)),
    ("float", (1, 0, 513))])
def test_kway_kernel_matches_plain(cuda, kind, sizes):
    runs, n_cmp = _sorted_runs(5, sizes, kind)
    before = kway_kernel.KERNEL.launches
    got = kway_kernel.merge_runs_kway_kernel(_to(runs, cuda), n_cmp=n_cmp)
    assert kway_kernel.KERNEL.launches == before + 1
    _same_bits(got, kway_kernel.merge_runs_kway_kernel(runs, n_cmp=n_cmp))
    _same_bits(got, kway_kernel.merge_runs_kway_take(runs, n_cmp=n_cmp))


def test_kway_kernel_refuses_more_runs_than_a_launch_takes(cuda):
    runs = [(torch.tensor([r], dtype=torch.int32, device=cuda),)
            for r in range(kway_kernel.MAX_RUNS + 1)]
    with pytest.raises(ValueError, match="at most"):
        kway_kernel.merge_runs_kway_kernel(runs)


@pytest.mark.parametrize("engine,kernel", [
    ("auto", kway_kernel.KERNEL), ("kway_kernel", kway_kernel.KERNEL),
    ("tournament", runmerge_kernel.KERNEL)])
def test_chunked_sort_on_the_card_launches_its_merge_kernel(cuda, engine,
                                                            kernel):
    words = synthetic_words(5000, seed=6)
    kernel.launches = 0
    got = chunked_sort_words(words, chunk_size=1024, validate="full",
                             merge_engine=engine, device=cuda)
    assert kernel.launches > 0
    assert got == sorted(words, key=lambda w: (len(w.encode()), w.encode()))


def _partition_case(kind):
    """``(keys (R, C), splitters (S,))`` int32 numpy arrays of ``kind``."""
    rng = np.random.default_rng(7)
    info = np.iinfo(np.int32)
    if kind == "extremes":
        keys = rng.integers(-5, 5, (3, 1000)).astype(np.int32)
        keys[:, ::3], keys[:, 1::3] = info.max, info.min
        return keys, np.array([info.min, -1, 0, 4, info.max], np.int32)
    keys = rng.integers(-1000, 1000, (64, 16_384)).astype(np.int32)
    if kind == "127 sorted":
        return keys, np.sort(rng.choice(2000, 127, replace=False) - 1000
                             ).astype(np.int32)
    if kind == "unsorted, duplicated":
        return keys[:8, :130], np.array([500, -3, 7, 7, 7, -900, 500],
                                        np.int32)
    if kind == "none":
        return keys[:1, :130], np.zeros(0, np.int32)
    return keys[:5], np.sort(rng.integers(-1000, 1000, 5000)).astype(
        np.int32)                                    # "5000 splitters"


@pytest.mark.parametrize("kind", ["extremes", "127 sorted",
                                  "unsorted, duplicated", "none",
                                  "5000 splitters"])
def test_partition_kernel_matches_plain(cuda, kind):
    keys, spl = (torch.from_numpy(a) for a in _partition_case(kind))
    before = partition_kernel.KERNEL.launches
    got = partition_kernel.partition_rows(keys.to(cuda), spl.to(cuda))
    assert partition_kernel.KERNEL.launches == before + 1
    want = partition_kernel.partition_rows_plain(keys, spl)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def test_partition_rows_wraps_uint32_keys_on_the_card(cuda):
    keys = torch.tensor([[-1294967296, 1, 2, 5]], dtype=torch.int32).view(
        torch.uint32)                                # 3,000,000,000 first
    spl = torch.tensor([2], dtype=torch.int32)
    bid, cnt = ops.partition_rows(keys.view(torch.int32).to(cuda).view(
        torch.uint32), spl.to(cuda))
    assert bid.cpu().tolist() == [[0, 0, 1, 1]]
    assert cnt.cpu().tolist() == [[2, 2]]


@pytest.mark.parametrize("dtype", [torch.int8, torch.int16, torch.uint8,
                                   torch.uint16])
@pytest.mark.parametrize("n", [100, 1000, 20_000])
def test_narrow_sort_on_the_card_matches_the_cpu(cuda, dtype, n):
    """OETS, bitonic and blocksort tiers, through widening and back."""
    info = torch.iinfo(dtype)
    rng = np.random.default_rng(n)
    x = torch.from_numpy(rng.integers(info.min, info.max, n,
                                      endpoint=True).astype(np.int64))
    x[:2] = torch.tensor([info.max, info.min])
    x = x.to(torch.int32)
    x = lex.from_bits(x, dtype)
    got = ops.sort(lex.from_bits(lex.as_bits(x).to(cuda), dtype))
    assert got.dtype == dtype
    want = ops.sort(x)
    assert torch.equal(lex.as_bits(got).cpu(), lex.as_bits(want))
    assert torch.equal(lex.as_bits(want), torch.sort(lex.as_bits(x)).values)


@pytest.mark.parametrize("n", [96, 1000, 20_000])
def test_packed_sort_lex_on_the_card_matches_the_cpu(cuda, n):
    """Two bounded int32 lanes resolve to the packed engine and equal the
    lanes engine bit for bit; a float32 lane of NaNs and ±0 beside an int32
    lane takes the (rank keys, iota) gather, whose order is unique, and
    equals the CPU's bit for bit."""
    rng = np.random.default_rng(n)
    lanes = [torch.from_numpy(rng.integers(0, 1024, n).astype(np.int32))
             .to(cuda) for _ in range(2)]
    assert ops.choose_lex_engine([torch.int32] * 2, (1023, 1023)) == "packed"
    got = ops.sort_lex(lanes, max_values=(1023, 1023))
    _same_bits(got, ops.sort_lex(lanes, engine="lanes"))
    f = rng.normal(size=n).astype(np.float32)
    pick = rng.random(n)
    f[pick < 0.2] = np.nan
    f[(pick >= 0.2) & (pick < 0.3)] = -0.0
    f[pick >= 0.9] = np.array([0x7FC00001], np.uint32).view(np.float32)
    lanes = [torch.from_numpy(f).to(cuda),
             torch.from_numpy(rng.integers(-3, 3, n).astype(np.int32)).to(cuda)]
    got = ops.sort_lex(lanes, engine="packed")
    _same_bits(got, ops.sort_lex([l.cpu() for l in lanes], engine="packed"))


# --- B4's register and shuffle mapping, B7's sorted-splitter search --------

_MERGE_LANES = (1, 2, 3, 4, 5, 8, 9)


def _sort_blocks(x, codes, block):
    """Each ``block``-wide block of every row of stacked ``x`` sorted in the
    lex order of its order keys (a chain of stable sorts, on the CPU)."""
    z = x.reshape(x.shape[0], -1, block)
    keys = lex.order_keys(z, codes)
    perm = torch.arange(block).expand(z.shape[1], -1).contiguous()
    for a in reversed(range(z.shape[0])):
        _, idx = torch.sort(keys[a].gather(-1, perm), dim=-1, stable=True)
        perm = perm.gather(-1, idx)
    return torch.stack([lane.gather(-1, perm) for lane in z]).reshape(x.shape)


@pytest.mark.parametrize("fill", adversarial.FILLS)
@pytest.mark.parametrize("code", [lex.U32, lex.I32, lex.F32])
@pytest.mark.parametrize("n", _MERGE_LANES)
def test_merge_kernel_every_block_matches_plain(cuda, n, code, fill):
    """Every power-of-two block from 1 to the shared-memory cap, at offsets
    0 and ``block``: the in-thread, shuffle and shared-memory stages."""
    rng = np.random.default_rng([n, code, len(fill)])
    codes = [code] * n
    block = 1
    while block <= merge_kernel.max_merge_block(n):
        x = torch.from_numpy(adversarial.lane_bits(
            rng, (n, 3, 7 * block), code, fill))
        x = _sort_blocks(x, codes, block)
        xc = x.to(cuda)
        for lo in (0, block):
            before = merge_kernel.KERNEL.launches
            got = merge_kernel.merge_adjacent_lex(xc.clone(), codes,
                                                  block=block, lo=lo)
            assert merge_kernel.KERNEL.launches == before + 1
            want = x.clone()
            want[..., lo:lo + 6 * block] = merge_kernel.merge_network_plain(
                x[..., lo:lo + 6 * block], codes, block)
            assert torch.equal(got.cpu(), want), (block, lo)
        block *= 2


_SPLITTER_COUNTS = (0, 1, 2, 31, 32, 33, 127, 128, 1000,
                    partition_kernel.MAX_SPLITTERS)


@pytest.mark.parametrize("cols", [1, 3, 130, 16_385])
@pytest.mark.parametrize("n_spl", _SPLITTER_COUNTS)
def test_partition_kernel_sweep_matches_plain(cuda, n_spl, cols):
    keys, spl = (torch.from_numpy(a).to(cuda)
                 for a in adversarial.partition_case(n_spl, cols, seed=11))
    before = partition_kernel.KERNEL.launches
    got = partition_kernel.partition_rows(keys, spl)
    assert partition_kernel.KERNEL.launches == before + 1
    want = partition_kernel.partition_rows_plain(keys, spl)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    ref = torch.searchsorted(torch.sort(spl).values, keys, right=True)
    assert torch.equal(got[0].long(), ref)
