"""The CUDA kernels against their plain versions on the card.

Every test here carries the ``gpu`` marker and takes the ``cuda`` fixture,
which skips where there is no card; run them on the card with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""

import json

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
from repro_torch.kernels._build import SMEM_LIMIT
from repro_torch.kernels.keypack import packed_cmp_lanes
from repro_torch.pipeline import RunStore, chunked_sort_words, merge_runs
from repro_torch.runtime import (RetryPolicy, SortSupervisor, StageFailure,
                                 StageFailureInjector)
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


@pytest.mark.parametrize("shape,block,code,fill", [
    pytest.param((4, 17, 389_120), 4096, lex.U32, "sentinel", id="ds2x8"),
    pytest.param((4, 17, 233_472), 4096, lex.U32, "dup_heavy", id="chunk"),
    pytest.param((2, 1, 32 * 8192), 8192, lex.I32, "dup_heavy",
                 id="granite_dispatch_kv"),
    pytest.param((9, 3, 11 * 1024), 1024, lex.U32, "sentinel", id="nine"),
    # DS2's shortlex tuple in one row: a 48 KB tile, the most a block
    # takes without opting in
    pytest.param((6, 1, 57 * 4096), 4096, lex.U32, "sentinel", id="six"),
    pytest.param((3, 5, 13 * 2048), 2048, lex.F32, "nan", id="float"),
    pytest.param((3, 4, 7 * 1024 - 300), 1024, lex.U32, "dup_heavy",
                 id="short_tail")])
def test_merge_pairs_kernel_matches_plain(cuda, shape, block, code, fill):
    """Every round of blocksort at the word sort's bucket tensors (DS2 x 8
    in one call, a chunk of the chunked sort), a MoE dispatch sort's kv
    pair, six and nine lanes, float lanes, and rows whose last run is
    short: one launch a round, the plain version's bits (the stable merge:
    float ties too)."""
    rng = np.random.default_rng(list(shape))
    codes = [code] * shape[0]
    x = torch.from_numpy(adversarial.lane_bits(rng, shape, code, fill))
    x = merge_kernel.merge_pairs_plain(x.to(cuda), codes, block // 2)
    run = block
    while run < shape[2]:
        y = torch.empty_like(x)
        before = merge_kernel.PAIRS_KERNEL.launches
        merge_kernel.merge_pairs_lex(x, y, codes, run=run)
        assert merge_kernel.PAIRS_KERNEL.launches == before + 1
        assert torch.equal(y, merge_kernel.merge_pairs_plain(x, codes, run)), \
            run
        x, run = y, run * 2


def test_merge_pairs_kernel_stays_in_bounds_on_unsorted_runs(cuda):
    """Runs that break the contract (unsorted) give co-ranks out of order;
    the kernel still reads and writes only inside its tensors."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(adversarial.lane_bits(
        rng, (4, 17, 94 * 4096), lex.U32, "sentinel")).to(cuda)
    y = torch.empty_like(x)
    for run in (4096, 8192, 65536):
        merge_kernel.merge_pairs_lex(x, y, [lex.U32] * 4, run=run)
        torch.cuda.synchronize()


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
    split = runmerge_kernel.SPLIT_KERNEL.launches
    got = runmerge_kernel.merge_runs_lex_kernel(a, b, n_cmp=n_cmp)
    assert runmerge_kernel.KERNEL.launches == before + 1
    assert runmerge_kernel.SPLIT_KERNEL.launches == split + 1
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


@pytest.mark.parametrize("fill", adversarial.FILLS)
@pytest.mark.parametrize("k", adversarial.KWAY_SWEEP)
def test_kway_split_and_merge_kernels_match_plain(cuda, k, fill):
    """The split's rounds, the gather and B6 on ``adversarial.kway_case``
    runs: the cursors bit for bit those of the plain split and of the
    oracle (``kway_cursors(kway_ranks(...))``), the gathered lanes the
    plain concatenation's, the merge the plain merge tree's, at blocks 128
    and 256."""
    rng = np.random.default_rng([k, len(fill), 17])
    n_cmp = 1 + k % 5
    runs, codes = adversarial.kway_case(rng, n_cmp, fill, k, 90)
    cpu = [tuple(torch.from_numpy(x) for x in r) for r in runs]
    gpu = _to(cpu, cuda)
    oracle_ranks = kway_kernel.kway_ranks([r[:n_cmp] for r in cpu])
    for block in (128, 256):
        before = kway_kernel.SPLIT_KERNEL.launches
        cmp, data, cursors, _ = kway_kernel.kway_operands(gpu, n_cmp, None,
                                                          block)
        assert kway_kernel.SPLIT_KERNEL.launches == before + max(
            1, (k - 1).bit_length())
        p_cmp, p_data, p_cursors, _ = kway_kernel.kway_operands(cpu, n_cmp,
                                                                None, block)
        assert torch.equal(data.cpu(), p_data)
        assert torch.equal(cursors.cpu(), p_cursors), block
        assert torch.equal(cursors.cpu(), kway_kernel.kway_cursors(
            oracle_ranks, block)), block
        got = kway_kernel.kway_merge(cmp, data, cursors, codes, block)
        assert torch.equal(got.cpu(), kway_kernel.kway_merge_plain(
            p_cmp, p_data, p_cursors, codes, block)), block
        starts = kway_kernel.kway_starts(cmp, [r[0].shape[0] for r in gpu],
                                         codes, block)
        assert torch.equal(starts, cursors)


def test_kway_front_end_launches_on_57_runs(cuda):
    """One ``merge_runs_kway_kernel`` call on 57 runs: one gather, the
    split's ceil(log2 57) = 6 rounds, one merge."""
    runs, n_cmp = _sorted_runs(5, (900,) * 56 + (130,), "u32")
    runs = _to(runs, cuda)
    kernels = (kway_kernel.GATHER_KERNEL, kway_kernel.SPLIT_KERNEL,
               kway_kernel.KERNEL)
    before = [k.launches for k in kernels]
    kway_kernel.merge_runs_kway_kernel(runs, n_cmp=n_cmp)
    torch.cuda.synchronize()
    assert [k.launches - b for k, b in zip(kernels, before)] == [1, 6, 1]


def test_kway_kernel_refuses_more_runs_than_a_launch_takes(cuda):
    runs = [(torch.tensor([r], dtype=torch.int32, device=cuda),)
            for r in range(kway_kernel.MAX_RUNS + 1)]
    with pytest.raises(ValueError, match="at most"):
        kway_kernel.merge_runs_kway_kernel(runs)


@pytest.mark.parametrize("engine", ["auto", "kway"])
def test_kway_front_ends_merge_past_one_launch_on_the_card(cuda, engine):
    """1025 one-element runs: past what one launch of the k-way kernel
    takes, so the front end takes the 'take' tier (its result the CPU's)."""
    rng = np.random.default_rng(23)
    keys = rng.integers(-40, 40, kway_kernel.MAX_RUNS + 1).astype(np.int32)
    runs = [(torch.from_numpy(keys[r:r + 1]), torch.tensor([r],
                                                           dtype=torch.int32))
            for r in range(len(keys))]
    before = kway_kernel.KERNEL.launches
    got = merge_runs(_to(runs, cuda), engine=engine)
    assert kway_kernel.KERNEL.launches == before
    _same_bits(got, merge_runs(runs, engine=engine))
    order = np.lexsort((np.arange(len(keys)), keys))
    assert got[1].cpu().tolist() == order.tolist()


def test_chunked_sort_of_1030_chunks_on_the_card(cuda):
    """More chunks than one launch of the k-way kernel merges: the default
    merge engine still returns the shortlex order."""
    words = synthetic_words(1030, seed=0)
    got = chunked_sort_words(words, chunk_size=1, device=cuda)
    assert got == sorted(words, key=lambda w: (len(w.encode()), w.encode()))


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


def _shortlex(words):
    return sorted(words, key=lambda w: (len(w.encode()), w.encode()))


@pytest.fixture
def warm(cuda):
    """The kernels built and loaded before a timed or supervised run: a
    first build holds the build lock for as long as ``nvcc`` takes."""
    chunked_sort_words(synthetic_words(3000, seed=1), chunk_size=1024,
                       merge_engine="tournament", device=cuda)
    chunked_sort_words(synthetic_words(3000, seed=1), chunk_size=1024,
                       device=cuda)
    return cuda


def test_chunked_sort_resumes_after_a_kill_on_the_card(warm, tmp_path):
    """DS2 at chunk 4096 (57 runs) with a store: a job that fails every
    chunk sort from chunk 30 on dies holding runs 0..29; the resume sorts
    exactly the 27 it lacks, and a second resume sorts none."""
    from repro_torch.configs import DS2
    words = synthetic_words(DS2.n_words, seed=0)
    want = _shortlex(words)
    store = RunStore(str(tmp_path))
    sup = SortSupervisor(policy=RetryPolicy(max_retries=0),
                         injector=StageFailureInjector(
                             fail_at={"ingest_chunk": set(range(30, 57))}))
    with pytest.raises(StageFailure):
        chunked_sort_words(words, store=store, supervisor=sup, device=warm)
    assert store.completed() == list(range(30))
    for resorted in (27, 0):
        distribute_kernel.KERNEL.launches = 0
        got = chunked_sort_words(words, store=RunStore(str(tmp_path)),
                                 validate="full", device=warm)
        assert distribute_kernel.KERNEL.launches == resorted
        assert got == want
    assert store.completed() == list(range(57))


def test_chunk_sort_failure_recovered_on_the_card_with_a_deadline(warm):
    """A deadline runs each chunk sort on a worker thread, which must
    launch on the caller's stream (here not the default one); an injected
    failure of chunk 2's sort is retried, and the merge too."""
    words = synthetic_words(20_000, seed=5)
    inj = StageFailureInjector(fail_at={"ingest_chunk": {2},
                                        "streaming_combine": {0}})
    sup = SortSupervisor(injector=inj,
                         deadlines={"ingest_chunk": 60.0,
                                    "streaming_combine": 60.0})
    side = torch.cuda.Stream(warm)
    distribute_kernel.KERNEL.launches = 0
    with torch.cuda.stream(side):
        got = chunked_sort_words(words, chunk_size=4096, validate="full",
                                 supervisor=sup, device=warm)
    assert got == _shortlex(words)
    assert distribute_kernel.KERNEL.launches == 5
    assert [(e.stage, e.action) for e in sup.events] == \
        [("ingest_chunk", "retry"), ("streaming_combine", "retry")]


def test_supervised_stage_on_a_worker_takes_the_callers_stream(cuda):
    side = torch.cuda.Stream(cuda)
    sup = SortSupervisor(deadlines={"ingest_chunk": 30.0})
    with torch.cuda.stream(side):
        seen = sup.run_stage("ingest_chunk", torch.cuda.current_stream)
    assert seen == side
    assert torch.cuda.current_stream() != side


def test_launch_counter_loses_no_update_across_threads(cuda):
    """Supervised stages may launch from worker threads: 16 threads, a
    switch interval of a microsecond, 100 launches each — the counter
    counts every one."""
    import sys
    import threading
    keys = torch.zeros((64, 1), dtype=torch.int32, device=cuda)
    distribute_kernel.distribute_rows(keys)
    kernel = distribute_kernel.KERNEL
    before = kernel.launches

    def launch():
        for _ in range(100):
            distribute_kernel.distribute_rows(keys)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=launch) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1600


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


# --- the register networks (B2, B4), B3's look-back, B7's search -----------

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


@pytest.mark.parametrize("fill", adversarial.FILLS)
@pytest.mark.parametrize("code", [lex.U32, lex.I32, lex.F32])
@pytest.mark.parametrize("n", _MERGE_LANES)
def test_bitonic_kernel_every_width_matches_plain(cuda, n, code, fill):
    """Every power-of-two column count from 1 to the shared-memory cap: the
    register-only kernel up to 128 columns, then the window kernel's
    in-thread, shuffle and shared-memory stages."""
    rng = np.random.default_rng([n, code, len(fill), 2])
    codes = [code] * n
    cols = 1
    while n * cols * 4 <= SMEM_LIMIT:
        x = torch.from_numpy(adversarial.lane_bits(rng, (n, 3, cols), code,
                                                   fill))
        before = bitonic_kernel.KERNEL.launches
        got = bitonic_kernel.bitonic_rows_lex(x.to(cuda), codes)
        assert bitonic_kernel.KERNEL.launches == before + 1
        assert torch.equal(got.cpu(),
                           bitonic_kernel.bitonic_rows_lex_plain(x, codes)), \
            cols
        cols *= 2


_DISTRIBUTE_N = (0, 1, 31, 32, 33, 1023, 1024, 1025, 4096, 65_537, 230_000,
                 1_048_577)


@pytest.mark.parametrize("fill", adversarial.WORD_FILLS)
@pytest.mark.parametrize("lanes", range(1, 9))
def test_distribute_kernel_sweep_matches_plain(cuda, lanes, fill):
    """Word counts around a warp, a tile, the look-back's 32-tile step and
    the switch to four words a thread (past 64 tiles), up to a million;
    ``n_valid`` 0, ``n - 777`` and ``n``; at 4 and 8 lanes also words off
    16-byte alignment (the scalar loads)."""
    rng = np.random.default_rng([lanes, len(fill)])
    words = torch.from_numpy(adversarial.packed_words(
        rng, max(_DISTRIBUTE_N), lanes, fill)).to(cuda)
    for n in _DISTRIBUTE_N:
        cases = [words[:n]]
        if lanes % 4 == 0:
            shifted = torch.empty(n * lanes + 1, dtype=torch.int32,
                                  device=cuda)
            cases.append(shifted[1:].view(n, lanes).copy_(words[:n]))
        for keys in cases:
            for n_valid in sorted({0, max(n - 777, 0), n}):
                before = distribute_kernel.KERNEL.launches
                got = distribute_kernel.distribute_rows(keys, n_valid)
                assert distribute_kernel.KERNEL.launches == before + 1
                want = distribute_kernel.distribute_rows_plain(keys, n_valid)
                for g, w in zip(got, want):
                    assert torch.equal(g, w), (n, n_valid)


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


# --- B1's warp and shared-memory kernels, B5's split and merge --------------

@pytest.mark.parametrize("fill", adversarial.FILLS)
@pytest.mark.parametrize("code", [lex.U32, lex.I32, lex.F32])
@pytest.mark.parametrize("n", _MERGE_LANES)
def test_oets_kernel_sweep_matches_plain(cuda, n, code, fill):
    """1, 17, 33 and 133 rows (a block's last warps without a row), 100 and
    128 columns (one warp a row, in registers) and 256 (a block a row, in
    shared memory): the plain version's bits, and the stable sort's."""
    rng = np.random.default_rng([n, code, len(fill), 1])
    codes = [code] * n
    for rows in (1, 17, 33, 133):
        for cols in (100, 128, 256):
            x = torch.from_numpy(adversarial.lane_bits(rng, (n, rows, cols),
                                                       code, fill))
            before = oets_kernel.KERNEL.launches
            got = oets_kernel.oets_rows_lex(x.to(cuda), codes).cpu()
            assert oets_kernel.KERNEL.launches == before + 1
            assert torch.equal(got, oets_kernel.oets_rows_lex_plain(
                x, codes)), (rows, cols)
            assert torch.equal(got, _sort_blocks(x, codes, cols)), (rows, cols)


@pytest.mark.parametrize("fill", adversarial.FILLS)
@pytest.mark.parametrize("n_cmp", range(1, runmerge_kernel.MAX_CMP_LANES + 1))
def test_runmerge_kernel_sweep_matches_plain(cuda, n_cmp, fill):
    """Every compare-lane count at every co-rank edge of
    ``adversarial.MERGE_EDGES``, blocks 128 and 256: the split kernel's
    starts equal the plain split's, and the merge's bits the plain
    merge's."""
    rng = np.random.default_rng([n_cmp, len(fill), 9])
    for edge in adversarial.MERGE_EDGES:
        a, b, codes = adversarial.merge_case(rng, n_cmp, fill, edge)
        da, db = (torch.from_numpy(np.stack(r)).to(cuda) for r in (a, b))
        sa, sb = da[:n_cmp], db[:n_cmp]
        for block in (128, 256):
            before = runmerge_kernel.SPLIT_KERNEL.launches
            starts = runmerge_kernel.merge_path_starts(sa, sb, block, codes)
            assert runmerge_kernel.SPLIT_KERNEL.launches == before + 1
            assert torch.equal(starts, runmerge_kernel.merge_path_starts_plain(
                sa, sb, codes, block)), (edge, block)
            before = runmerge_kernel.KERNEL.launches
            got = runmerge_kernel.runmerge(sa, sb, da, db, starts, codes,
                                           block)
            assert runmerge_kernel.KERNEL.launches == before + 1
            assert torch.equal(got, runmerge_kernel.runmerge_plain(
                sa, sb, da, db, starts, codes, block)), (edge, block)


# --- the mesh tier ----------------------------------------------------------

def _shortlex(words):
    return sorted(words, key=lambda w: (len(w.encode()), w.encode()))


@pytest.mark.parametrize("engine", ["auto", "tournament"])
def test_mesh_chunked_sort_on_eight_destinations_of_one_card(cuda, engine):
    """``distributed_chunked_sort_lex`` over ``[cuda:0] * 8``: equal to the
    CPU port's and to the shortlex order, through the kernels."""
    from repro_torch.core.distributed import distributed_chunked_sort_lex
    from repro_torch.kernels import KERNELS
    words = synthetic_words(20_000, seed=4)
    keys = packing.pack_words(words)
    for k in KERNELS.values():
        k.launches = 0
    run = distributed_chunked_sort_lex(keys, devices=[cuda] * 8,
                                       merge_engine=engine, validate="full")
    torch.cuda.synchronize()
    want = distributed_chunked_sort_lex(keys, devices=[torch.device("cpu")]
                                        * 8, merge_engine=engine)
    assert torch.equal(run.lengths.cpu(), want.lengths)
    assert np.array_equal(to_numpy(run.keys), to_numpy(want.keys))
    assert packing.unpack_words(to_numpy(run.keys)) == _shortlex(words)
    merge = "merge_runs_kway" if engine == "auto" else "merge_runs_lex"
    for name in ("distribute_rows", "bitonic_rows_lex", merge):
        assert KERNELS[name].launches > 0, name


def test_chaos_soak_on_eight_destinations_of_one_card(cuda, tmp_path):
    from repro_torch.runtime import chaos_soak
    keys = packing.pack_words(synthetic_words(200, seed=0))
    reports = chaos_soak(keys, seeds=range(6), workdir=str(tmp_path),
                         devices=[cuda] * 8, num_devices=8)
    assert all(r.ok for r in reports), [(r.seed, r.detail) for r in reports
                                        if not r.ok]


def test_engines_at_world_size_one_over_nccl(cuda, tmp_path):
    """Both engines and every odd-even merge at world size 1 over NCCL (the
    ring shift is skipped: no rank has a partner), equal to numpy's lex
    sort of the tuple."""
    import torch.distributed as dist
    from repro_torch.core.distributed import distributed_sort_lex
    from repro_torch.parallel import make_mesh
    rng = np.random.default_rng(5)
    n = 20_000
    lanes = [rng.integers(0, 16, n).astype(np.int32),
             rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32),
             np.arange(n, dtype=np.uint32)]
    order = np.lexsort(tuple(reversed(lanes)))
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/rv",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh((1,), ("data",), "cuda")
        for engine, merge in (("odd_even", "bitonic"), ("odd_even", "take"),
                              ("odd_even", "resort"), ("sample", "bitonic")):
            out = distributed_sort_lex(lanes, mesh, engine=engine,
                                       merge=merge, validate="full",
                                       device=cuda)
            for got, lane in zip(out, lanes):
                assert np.array_equal(to_numpy(got), lane[order]), engine
    finally:
        dist.destroy_process_group()


# ---------------- the serving path ----------------

def _uint32(seed, shape):
    """uint32 keys past 2^31, with ties on the first lane and sentinels."""
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)
    k[..., ::3, 0] = 0x80000001
    k[..., ::7, :] = 0xFFFFFFFF
    return torch.from_numpy(k.view(np.int32))


@pytest.mark.parametrize("algorithm", ["oets", "bitonic", "xla"])
def test_sort_buckets_networks_on_uint32_buckets(cuda, algorithm):
    """The networks and 'xla' work on int32 order bits: no uint32 tensor is
    indexed or compared on the card."""
    bits = _uint32(11, (5, 100, 3))
    want = bucketing.sort_buckets(bits.view(torch.uint32), algorithm)
    got = bucketing.sort_buckets(bits.to(cuda).view(torch.uint32), algorithm)
    assert torch.equal(got.view(torch.int32).cpu(), want.view(torch.int32))


@pytest.mark.parametrize("shape", [(301,), (301, 2)])
def test_oets_on_uint32_keys_on_the_card(cuda, shape):
    from repro_torch.core import oets
    bits = _uint32(12, shape + (1,))[..., 0]
    want = oets.oets_argsort(bits.view(torch.uint32))
    got = oets.oets_argsort(bits.to(cuda).view(torch.uint32))
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("n", [32, 200, 2000])
def test_admission_order_on_the_card_matches_the_cpu(cuda, n):
    """B1 (up to 128), B2 (256) and blocksort (2048) give the plain
    versions' permutation."""
    from repro_torch.serve import BucketedScheduler, Request
    rng = np.random.default_rng(n)
    rs = [Request(i, [int(t) for t in rng.integers(0, 4,
                                                   rng.integers(0, 6))])
          for i in range(n)]
    got = BucketedScheduler._order_by_length(rs, device=cuda)
    want = BucketedScheduler._order_by_length(rs, device="cpu")
    assert [r.request_id for r in got] == [r.request_id for r in want]


@pytest.mark.parametrize("n_tokens", [8, 100, 4096])
def test_moe_pallas_dispatch_permutation_on_the_card(cuda, n_tokens):
    """The kernels' dispatch permutation is the stable argsort's."""
    from repro_torch.models import moe
    e = torch.from_numpy(np.random.default_rng(n_tokens).integers(
        0, 32, 8 * n_tokens).astype(np.int32)).to(cuda)
    iota = torch.arange(e.numel(), dtype=torch.int32, device=cuda)
    ke, kp = moe._sort_assignments(e, iota, "pallas")
    xe, xp = moe._sort_assignments(e, iota, "xla")
    assert torch.equal(ke, xe) and torch.equal(kp.long(), xp.long())


@pytest.mark.parametrize("arch,sort_impl", [
    ("granite-moe-1b-a400m", "xla"), ("granite-moe-1b-a400m", "pallas"),
    ("deepseek-v2-236b", "pallas"), ("minicpm3-4b", "xla"),
    ("mamba2-370m", "xla"), ("zamba2-1.2b", "xla")])
def test_engine_greedy_on_the_card_matches_the_cpu(cuda, arch, sort_impl):
    """Smoke config in float32, TF32 off: the same engine's greedy tokens
    on the card and on the CPU; the MLA, Mamba2 and hybrid archs' batch
    also holds a 2-token prompt, whose conv window is the batch's
    padding."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_lm
    from repro_torch.serve import Engine
    cfg = get_smoke_config(arch)
    lm = init_lm(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    lengths = (3, 17, 9, 30) if arch == "granite-moe-1b-a400m" \
        else (3, 17, 9, 30, 2)
    prompts = [list(rng.integers(1, cfg.vocab_size, n)) for n in lengths]
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        want = Engine(cfg, lm, max_seq=64, sort_impl=sort_impl).generate(
            prompts, max_new=8)
        got = Engine(cfg, lm.to(cuda), max_seq=64,
                     sort_impl=sort_impl).generate(prompts, max_new=8)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow
    assert got == want


@pytest.mark.parametrize("sort_impl", ["xla", "pallas"])
def test_moe_forward_is_bit_identical_run_to_run(cuda, sort_impl,
                                                 monkeypatch):
    """C4: one MoE forward twice on the card — Granite's smoke config in
    bfloat16, 8 x 64 tokens over 4 experts top-2, so every expert takes
    many rows and every token sums two — gives the same bits and the same
    routing (expert ids and weights): the combine has no atomics."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import moe
    from repro_torch.models.param import Builder
    from repro_torch.parallel.sharding import Rules
    cfg = get_smoke_config("granite-moe-1b-a400m").replace(
        param_dtype="bfloat16", compute_dtype="bfloat16")
    assert (cfg.moe.n_experts, cfg.moe.top_k) == (4, 2)
    gen = torch.Generator(device=cuda).manual_seed(0)
    layer = moe.MoE(Builder(gen, dtype=torch.bfloat16, device=cuda), cfg)
    x = torch.randn((8, 64, cfg.d_model), generator=gen,
                    device=cuda).to(torch.bfloat16)
    routes, real = [], moe._route

    def rec(cfg_, p, xf):
        out = real(cfg_, p, xf)
        routes.append(out)
        return out

    monkeypatch.setattr(moe, "_route", rec)
    with torch.inference_mode():
        runs = [moe.moe(cfg, layer, x, Rules(), sort_impl=sort_impl)
                for _ in range(2)]
    (y0, aux0), (y1, aux1) = runs
    assert y0.dtype == torch.bfloat16
    assert torch.equal(y0.view(torch.int16), y1.view(torch.int16))
    assert torch.equal(aux0, aux1)
    assert len(routes) == 2
    (p0, e0, _), (p1, e1, _) = routes
    assert torch.equal(e0, e1) and torch.equal(p0, p1)
    per_expert = torch.bincount(e0.reshape(-1), minlength=4)
    assert int(per_expert.min()) > 1


def _train_grads(cfg, lm, batch, sort_impl):
    from repro_torch.models import lm_loss
    from repro_torch.parallel.sharding import Rules
    names, params = zip(*lm.named_parameters())
    loss, _ = lm_loss(cfg, lm, batch, Rules(), sort_impl=sort_impl)
    return loss.detach(), dict(zip(names, torch.autograd.grad(loss, params)))


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.detach().contiguous().view(
        torch.int16 if t.element_size() == 2 else torch.int32)


@pytest.mark.parametrize("sort_impl", ["xla", "pallas"])
def test_train_step_is_bit_identical_run_to_run(cuda, sort_impl):
    """C6, the backward counterpart of C4: Granite's smoke config in
    bfloat16 (remat 'dots'), 8 x 64 tokens over 4 experts top-2 — the loss,
    every gradient (the embedding's and the dispatch gather's sum rows
    that many tokens share) and the parameters after a train step are the
    same bits in two runs."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import TokenStream
    from repro_torch.interop import to_device
    from repro_torch.models import init_lm
    from repro_torch.optim import init_opt_state
    from repro_torch.parallel.sharding import Rules
    from repro_torch.training import Hyper, make_train_step
    cfg = get_smoke_config("granite-moe-1b-a400m").replace(
        param_dtype="bfloat16", compute_dtype="bfloat16", remat="dots")
    batch = {k: to_device(v, cuda) for k, v in next(TokenStream(
        cfg.vocab_size, 8, 64, seed=0)).items()}
    runs = []
    for _ in range(2):
        lm = init_lm(cfg, seed=0, device=cuda)
        loss, grads = _train_grads(cfg, lm, batch, sort_impl)
        opt = init_opt_state(lm)
        step = make_train_step(cfg, Rules(), Hyper(lr=1e-3, warmup=0,
                                                   sort_impl=sort_impl))
        lm, opt, m = step(lm, opt, batch, 1)
        runs.append((loss, grads, dict(lm.named_parameters()), m))
    (l0, g0, p0, m0), (l1, g1, p1, m1) = runs
    assert torch.equal(_bits(l0), _bits(l1))
    assert g0["embed"].dtype == torch.bfloat16
    assert all(torch.equal(_bits(g0[k]), _bits(g1[k])) for k in g0)
    assert all(torch.equal(_bits(p0[k]), _bits(p1[k])) for k in p0)
    assert all(torch.equal(m0[k], m1[k]) for k in ("loss", "grad_norm"))


@pytest.mark.parametrize("arch", ["glm4-9b", "granite-moe-1b-a400m",
                                  "minicpm3-4b", "mamba2-370m",
                                  "zamba2-1.2b", "musicgen-large"])
def test_train_steps_on_the_card_match_the_cpu(cuda, arch):
    """Three float32 train steps at the smoke config, the dispatch on the
    kernels, from the same weights on the card and the CPU (TF32 off):
    losses within 1e-4 and gradient norms within 5e-4, relative
    (``chip_smoke.TRAIN_LOSS_RTOL``, ``TRAIN_GNORM_RTOL``)."""
    import copy
    from repro_torch.configs import get_smoke_config
    from repro_torch.interop import to_device
    from repro_torch.launch.train import _make_batch_iter
    from repro_torch.models import init_lm
    from repro_torch.optim import init_opt_state
    from repro_torch.parallel.sharding import Rules
    from repro_torch.training import Hyper, make_train_step
    cfg = get_smoke_config(arch)
    cpu_lm = init_lm(cfg, seed=0, device="cpu")
    out = {}
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for dev, lm in (("cpu", cpu_lm),
                        (cuda, copy.deepcopy(cpu_lm).to(cuda))):
            opt = init_opt_state(lm)
            step = make_train_step(cfg, Rules(), Hyper(
                lr=1e-3, warmup=1, total_steps=3, sort_impl="pallas"))
            it = _make_batch_iter(cfg, 2, 32)
            out[str(dev)] = []
            for s in range(3):
                batch = {k: to_device(v, dev) for k, v in next(it).items()}
                lm, opt, m = step(lm, opt, batch, s)
                out[str(dev)].append((float(m["loss"]),
                                      float(m["grad_norm"])))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow
    got, want = np.array(out["cuda"]), np.array(out["cpu"])
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=1e-4)
    np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=5e-4)


def test_bfloat16_snapshot_round_trips_on_the_card(cuda, tmp_path):
    """C5: a bf16 model's weights and float32 moments saved from the card
    and restored onto it, bit for bit, with the reference's manifest."""
    from repro_torch.checkpoint import CheckpointManager, read_manifest
    from repro_torch.configs import get_smoke_config
    from repro_torch.interop import (lm_to_reference, named_from_reference,
                                     opt_state_to_reference)
    from repro_torch.models import init_lm
    from repro_torch.optim import init_opt_state
    cfg = get_smoke_config("granite-moe-1b-a400m").replace(
        param_dtype="bfloat16")
    lm = init_lm(cfg, seed=3, device=cuda)
    opt = init_opt_state(lm)
    for t in opt["m"].values():
        t.normal_()
    tree = {"params": lm_to_reference(lm), "opt": opt_state_to_reference(opt)}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(5, tree)
    step, back = mgr.restore_latest(tree, device=cuda)
    assert step == 5
    params = named_from_reference(back["params"])
    moments = named_from_reference(back["opt"]["m"])
    for name, p in lm.named_parameters():
        assert params[name].dtype == torch.bfloat16
        assert params[name].device == p.device
        assert torch.equal(_bits(params[name]), _bits(p))
        assert torch.equal(moments[name], opt["m"][name])
    dtypes = {e["dtype"] for e in read_manifest(str(tmp_path), 5)["leaves"]}
    assert dtypes == {"bfloat16", "float32", "int32"}


# ---------------- the parallel plan: 2 gloo ranks of one card ----------------

_PLAN_RANK = r"""
import copy, dataclasses, types
import json

import numpy as np
from repro_torch.configs import get_smoke_config
from repro_torch.interop import to_numpy
from repro_torch.models import forward, init_lm
from repro_torch.models.moe import moe
from repro_torch.models.moe_ep import ep_moe
from repro_torch.models.param import shard_lm
from repro_torch.optim import init_opt_state
from repro_torch.parallel.compat import make_mesh, set_mesh
from repro_torch.parallel.sharding import Rules
from repro_torch.training import Hyper, make_train_step

dev = torch.device("cuda", 0)
torch.cuda.set_device(dev)
torch.backends.cuda.matmul.allow_tf32 = False
rules, out = Rules(), {}
mesh = make_mesh((1, 2), ("data", "model"), "cuda")
cfg = get_smoke_config("granite-moe-1b-a400m")
lm = init_lm(cfg, seed=0, device=dev)
rng = np.random.default_rng(1)
tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 32))).to(dev)
labels = torch.roll(tokens, -1, 1)
with torch.no_grad():
    out["fwd/single"] = to_numpy(forward(cfg, lm, {"tokens": tokens}, rules,
                                         sort_impl="pallas")[0])
    lm_s = shard_lm(copy.deepcopy(lm), rules, mesh)
    with set_mesh(mesh):
        out["fwd/sharded"] = to_numpy(forward(
            cfg, lm_s, {"tokens": tokens}, rules, sort_impl="pallas")[0])
for k, v in lm.named_parameters():
    out[f"train/init/{k}"] = to_numpy(v)
for key, sharded in (("single", False), ("sharded", True)):
    l = copy.deepcopy(lm)
    if sharded:
        shard_lm(l, rules, mesh)
    step = make_train_step(cfg, rules, Hyper(lr=1e-3, warmup=1,
                                             total_steps=5,
                                             sort_impl="pallas"))
    opt = init_opt_state(l)
    if sharded:
        with set_mesh(mesh):
            l, opt, m = step(l, opt, {"tokens": tokens, "labels": labels}, 1)
    else:
        l, opt, m = step(l, opt, {"tokens": tokens, "labels": labels}, 1)
    for name in ("loss", "grad_norm", "lr"):
        out[f"train/{key}/{name}"] = to_numpy(m[name])
    for k, v in l.named_parameters():
        out[f"train/{key}/param/{k}"] = to_numpy(v)
        for mom in ("m", "v"):
            out[f"train/{key}/{mom}/{k}"] = to_numpy(opt[mom][k])
ep = make_mesh((2,), ("ep",), "cuda")
ecfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
g = torch.Generator(device=dev).manual_seed(3)
m_ = ecfg.moe
x = torch.randn(128, ecfg.d_model, generator=g, device=dev)
p = types.SimpleNamespace(
    router=torch.randn(ecfg.d_model, m_.n_experts, generator=g, device=dev),
    w_in=torch.randn(m_.n_experts, ecfg.d_model, 2 * m_.d_expert,
                     generator=g, device=dev) * 0.1,
    w_out=torch.randn(m_.n_experts, m_.d_expert, ecfg.d_model, generator=g,
                      device=dev) * 0.1)
y, _ = ep_moe(ecfg, ep, "ep", x, p.router, p.w_in, p.w_out)
out["ep/y"] = to_numpy(y)
with torch.no_grad():
    out["ep/moe"] = to_numpy(moe(ecfg, p, x[None], rules)[0][0])
if rank == 0:
    np.savez(workdir + "/plan.npz", **out)
"""


@pytest.fixture(scope="module")
def plan_run(tmp_path_factory):
    """The arrays of :data:`_PLAN_RANK` run by 2 gloo ranks on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from _torch_mesh import launch_ranks
    work = tmp_path_factory.mktemp("plan_gpu")
    launch_ranks(_PLAN_RANK, 2, work, timeout=300)
    return np.load(work / "plan.npz")


def test_sharded_smoke_forward_on_the_card(cuda, plan_run):
    np.testing.assert_allclose(plan_run["fwd/sharded"], plan_run["fwd/single"],
                               rtol=0, atol=2e-3)


def test_sharded_smoke_train_step_on_the_card(cuda, plan_run):
    """The step sharded against unsharded: the loss, the gradient norm,
    each parameter's change and the moments (``_torch_plan``'s bounds)."""
    from _torch_plan import assert_step_matches

    def part(key):
        pre = f"train/{key}/"
        return {k[len(pre):]: plan_run[k] for k in plan_run.files
                if k.startswith(pre)}
    assert_step_matches(part("init"), part("single"), part("sharded"))


def test_ep_moe_on_the_card_matches_moe(cuda, plan_run):
    np.testing.assert_allclose(plan_run["ep/y"], plan_run["ep/moe"], rtol=0,
                               atol=2e-4)


# ---------------- C8: the engine serves a sharded LM on the card ----------------

_C8_RANK = r"""
import copy, json
import json

import numpy as np
from repro_torch.configs import get_smoke_config
from repro_torch.models import init_lm
from repro_torch.models.param import shard_lm
from repro_torch.parallel.compat import make_mesh
from repro_torch.parallel.sharding import Rules
from repro_torch.serve import engine as E

dev = torch.device("cuda", 0)
torch.cuda.set_device(dev)
torch.backends.cuda.matmul.allow_tf32 = False
cfg = get_smoke_config("granite-moe-1b-a400m").replace(
    param_dtype="float32", compute_dtype="float32")
lm = init_lm(cfg, seed=0, device=dev)
rng = np.random.default_rng(0)
prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist()
           for n in (5, 9, 3, 7, 12, 4, 6, 8)]
want = E.Engine(cfg, copy.deepcopy(lm), max_seq=32,
                sort_impl="pallas").generate(prompts, 4)
shard_lm(lm, Rules(), make_mesh((1, 2), ("data", "model"), "cuda"),
         src_data_rank=None)
modes = []
forward, decode = E.forward, E.decode_step
def seen(fn):
    def run(*a, **k):
        modes.append(torch.is_inference_mode_enabled())
        return fn(*a, **k)
    return run
E.forward, E.decode_step = seen(forward), seen(decode)
got = E.Engine(cfg, lm, max_seq=32, sort_impl="pallas").generate(prompts, 4)
with open(f"{workdir}/c8_{rank}.json", "w") as f:
    json.dump({"want": want, "got": got, "modes": modes}, f)
"""


def test_sharded_engine_serves_on_the_card(cuda, tmp_path):
    """C8: ``Engine.generate`` on the LM sharded over 2 gloo ranks of the
    card (a ``(1, 2)`` mesh) runs outside ``inference_mode`` and gives the
    unsharded engine's greedy tokens, in float32."""
    from _torch_mesh import launch_ranks
    launch_ranks(_C8_RANK, 2, tmp_path, timeout=300)
    for r in range(2):
        out = json.loads((tmp_path / f"c8_{r}.json").read_text())
        assert out["got"] == out["want"]
        assert len(out["modes"]) == 4 and not any(out["modes"])
