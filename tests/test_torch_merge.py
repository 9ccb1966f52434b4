"""The port's run merges against the reference's, on the CPU (the kernels'
plain versions): the broadcast oracles of ``kernels/lex.py``, the rank and
merge primitives of ``kernels/keypack.py``, the two-run merge-path kernel
(B5, ``runmerge_kernel``), the k-way kernel (B6, ``kway_kernel``) and its
torch tier, and the ``ops`` front-ends with every engine.

Integer and uint32 lanes must agree bit for bit with the reference's jnp
tiers (its engines agree with each other there), and with its Pallas
kernels in interpret mode in a few small cases (block 128, at most 400
elements: the interpreter is slow). Float lanes are held to the contract —
sorted under the total order and a bit-level permutation of the input —
because the reference's own engines order float ties (``-0.0``/``+0.0``,
NaN payloads) differently from each other."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import keypack as rkp
from repro.kernels import lex as rlex
from repro.kernels import ops as rops
from repro.kernels.kway_kernel import kway_ranks as ref_kway_ranks
from repro.kernels.kway_kernel import merge_runs_kway_pallas
from repro.kernels.runmerge_kernel import merge_runs_lex_pallas
from repro.pipeline import merge_runs as ref_merge_runs
from repro.pipeline.validate import check_lanes_sorted, order_bits_view
from repro_torch.interop import to_device
from repro_torch.kernels import adversarial, keypack, kway_kernel, lex, \
    ops, runmerge_kernel
from repro_torch.pipeline import merge_runs


def _lane(rng, kind, n):
    if kind == "i32":
        return rng.integers(-2**31, 2**31, n).astype(np.int32)
    if kind == "dup":
        return rng.integers(0, 3, n).astype(np.uint32)
    v = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    if kind == "sentinel":
        v[rng.random(n) < 0.3] = 0xFFFFFFFF
        v[rng.random(n) < 0.1] = 0
    return v


def _float_lane(rng, n):
    f = rng.normal(scale=10.0, size=n).astype(np.float32)
    pick = rng.random(n)
    f[pick < 0.15] = np.nan
    f[(pick >= 0.15) & (pick < 0.3)] = -0.0
    f[(pick >= 0.3) & (pick < 0.45)] = 0.0
    f[(pick >= 0.45) & (pick < 0.5)] = np.inf
    pats = np.array([0x7FC00001, 0xFFC00000, 0x7F800001, 0xFFFFFFFF],
                    np.uint32).view(np.float32)
    m = pick >= 0.9
    f[m] = pats[rng.integers(0, len(pats), int(m.sum()))]
    return f


def _sorted_run(rng, n, kinds):
    """One run, sorted by the canonical order of its lanes (numpy)."""
    lanes = [_float_lane(rng, n) if k == "f32" else _lane(rng, k, n)
             for k in kinds]
    keys = [order_bits_view(l) if l.dtype == np.float32 else
            (l.view(np.uint32) ^ np.uint32(0x80000000)
             if l.dtype == np.int32 else l) for l in lanes]
    order = np.lexsort(tuple(reversed(keys)))
    return [np.ascontiguousarray(l[order]) for l in lanes]


def _runs(seed, sizes, kinds):
    rng = np.random.default_rng(seed)
    return [_sorted_run(rng, n, kinds) for n in sizes]


def _t(run):
    return tuple(to_device(l, "cpu") for l in run)


def _j(run):
    return tuple(jnp.asarray(l) for l in run)


def _bits(x) -> np.ndarray:
    a = x.view(torch.int32).numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)
    return np.ascontiguousarray(a).view(np.uint32)


def _assert_bits(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bits(g), _bits(w))


def _assert_contract(got, runs):
    """Sorted under the total order, and the same multiset of bit tuples
    as the concatenated input."""
    got = [_bits(g) for g in got]
    flat = [np.concatenate([_bits(np.asarray(r[i])) for r in runs])
            for i in range(len(got))]
    assert sorted(zip(*[g.tolist() for g in got])) == \
        sorted(zip(*[f.tolist() for f in flat]))
    typed = [g.view(np.asarray(runs[0][i]).dtype) for i, g in enumerate(got)]
    check_lanes_sorted(typed, what="port merge")


# --- lex.py: the broadcast oracles ------------------------------------------

@pytest.mark.parametrize("kinds", [("u32",), ("i32", "u32"),
                                   ("dup", "dup", "sentinel"), ("f32",),
                                   ("f32", "i32")])
@pytest.mark.parametrize("strict", [True, False])
def test_lex_rank_count_matches_reference(kinds, strict):
    a, b = _runs(1, (70, 50), kinds)
    got = lex.lex_rank_count(_t(a), _t(b), strict)
    want = rlex.lex_rank_count(_j(a), _j(b), strict)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kinds", [("u32",), ("i32", "u32"),
                                   ("dup", "dup", "sentinel")])
def test_lex_merge_take_matches_reference(kinds):
    a, b = _runs(2, (90, 61), kinds)
    _assert_bits(lex.lex_merge_take(_t(a), _t(b)),
                 rlex.lex_merge_take(_j(a), _j(b)))


# --- keypack.py ---------------------------------------------------------------

@pytest.mark.parametrize("kinds,max_values", [
    (("u32",), None), (("i32", "u32"), None), (("dup", "u32"), (2, None)),
    (("dup", "dup", "i32"), (2, 2, None)), (("f32",), None)])
def test_unpack_rank_keys_inverts_the_packing(kinds, max_values):
    (run,) = _runs(3, (64,), kinds)
    lanes = _t(run)
    pk = keypack.pack_rank_keys(lanes, max_values)
    got = keypack.unpack_rank_keys(pk.lanes, [l.dtype for l in lanes],
                                   max_values)
    want = rkp.unpack_rank_keys(
        rkp.pack_rank_keys(_j(run), max_values).lanes,
        [l.dtype for l in run], max_values)
    _assert_bits(got, want)


def test_unpack_rank_keys_refuses_a_lossy_plan():
    lanes = _t(_runs(3, (8,), ("u32", "u32", "u32"))[0])
    pk = keypack.pack_rank_keys(lanes)
    with pytest.raises(ValueError, match="lossy"):
        keypack.unpack_rank_keys(pk.lanes, [l.dtype for l in lanes])


@pytest.mark.parametrize("kinds,max_values", [
    (("u32",), None), (("i32", "u32"), None),
    (("dup", "u32", "u32", "u32", "u32"), (8, None, None, None, None)),
    (("u32", "u32", "u32"), None), (("f32", "i32"), None)])
def test_packed_cmp_lanes_match_reference(kinds, max_values):
    (run,) = _runs(4, (40,), kinds)
    got = keypack.packed_cmp_lanes(_t(run), max_values)
    want = rkp.packed_cmp_lanes(_j(run), max_values)
    _assert_bits(got, want)
    pk = keypack.pack_rank_keys(_t(run), max_values)
    _assert_bits(keypack.cmp_from_packed(pk.lanes, _t(run), max_values), want)


@pytest.mark.parametrize("kinds", [("u32",), ("i32",), ("u32", "i32"),
                                   ("dup", "dup", "sentinel"),
                                   ("sentinel", "u32", "u32", "i32")])
@pytest.mark.parametrize("side", ["left", "right"])
def test_lex_searchsorted_matches_reference(kinds, side):
    a, v = _runs(5, (150, 77), kinds)
    got = keypack.lex_searchsorted(_t(a), _t(v), side=side)
    want = rkp.lex_searchsorted(_j(a), _j(v), side=side)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got = keypack.packed_searchsorted(_t(a), _t(v), side=side)
    want = rkp.packed_searchsorted(_j(a), _j(v), side=side)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_lex_searchsorted_edges():
    a = _t(_runs(6, (0,), ("u32", "u32"))[0])
    v = _t(_runs(6, (5,), ("u32", "u32"))[0])
    assert keypack.lex_searchsorted(a, v).tolist() == [0] * 5
    with pytest.raises(ValueError, match="side"):
        keypack.lex_searchsorted(v, v, side="middle")
    with pytest.raises(ValueError, match="arity"):
        keypack.lex_searchsorted(v, v[:1])


@pytest.mark.parametrize("kinds,n_cmp", [
    (("u32",), None), (("dup", "dup", "sentinel"), None),
    (("i32", "u32", "u32"), None), (("dup", "u32", "u32"), 2)])
@pytest.mark.parametrize("sizes", [(100, 80), (1, 130), (129, 0)])
def test_merge_take_packed_matches_reference(kinds, n_cmp, sizes):
    a, b = _runs(7, sizes, kinds)
    _assert_bits(keypack.merge_take_packed(_t(a), _t(b), n_cmp=n_cmp),
                 rkp.merge_take_packed(_j(a), _j(b), n_cmp=n_cmp))


def test_merge_take_packed_float_contract():
    a, b = _runs(8, (120, 90), ("f32", "i32"))
    _assert_contract(keypack.merge_take_packed(_t(a), _t(b)), [a, b])


# --- B6's split and torch tier ------------------------------------------------

@pytest.mark.parametrize("sizes,kinds", [
    ((17,), ("u32",)), ((9, 13), ("dup", "dup")),
    ((32, 0, 21, 5, 40), ("dup", "u32")), ((30,) * 7, ("dup",)),
    ((64, 48, 33, 16, 9), ("sentinel", "i32", "u32"))])
def test_kway_ranks_match_reference(sizes, kinds):
    runs = _runs(9, sizes, kinds)
    got = kway_kernel.kway_ranks([_t(r) for r in runs])
    want = ref_kway_ranks([list(_j(r)) for r in runs])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_kway_ranks_break_ties_by_run_index():
    r0 = (torch.tensor([0, 5, 5], dtype=torch.int32),)
    r1 = (torch.tensor([5, 5, 7], dtype=torch.int32),)
    r2 = (torch.tensor([5, 9], dtype=torch.int32),)
    ranks = kway_kernel.kway_ranks([r0, r1, r2])
    assert [r.tolist() for r in ranks] == [[0, 1, 2], [3, 4, 6], [5, 7]]


@pytest.mark.parametrize("sizes,kinds,n_cmp", [
    ((5, 7), ("u32", "u32", "u32"), None),
    ((5, 0, 9, 3), ("i32", "u32"), None),
    ((64, 48, 33, 16, 9), ("dup", "dup", "sentinel"), None),
    ((40,) * 8, ("dup", "sentinel", "u32"), 2),
    ((300, 1, 257), ("u32", "i32", "dup", "u32"), None)])
@pytest.mark.parametrize("engine", ["take", "kernel"])
def test_merge_runs_lex_matches_reference_take(sizes, kinds, n_cmp, engine):
    runs = _runs(10, sizes, kinds)
    got = ops.merge_runs_lex([_t(r) for r in runs], engine=engine,
                             n_cmp=n_cmp, block_size=128)
    want = rops.merge_runs_lex([_j(r) for r in runs], engine="take",
                               n_cmp=n_cmp)
    _assert_bits(got, want)


def test_kway_kernel_matches_the_interpreted_pallas_kernel():
    runs = _runs(11, (130, 77, 50, 1), ("dup", "u32", "i32"))
    got = kway_kernel.merge_runs_kway_kernel([_t(r) for r in runs],
                                             block=128)
    want = merge_runs_kway_pallas([_j(r) for r in runs], block=128,
                                  interpret=True)
    _assert_bits(got, want)


@pytest.mark.parametrize("engine", ["take", "kernel"])
def test_merge_runs_lex_float_contract(engine):
    runs = _runs(12, (90, 0, 61, 150), ("f32", "i32"))
    got = ops.merge_runs_lex([_t(r) for r in runs], engine=engine,
                             block_size=128)
    _assert_contract(got, runs)
    # the kernel carries a source index, so its ties fall as the take tier's
    _assert_bits(got, kway_kernel.merge_runs_kway_take([_t(r) for r in runs]))


def test_kway_plain_windows_are_the_stable_merge():
    """The plain version at the pipeline's block over 57 runs: one window a
    block, the cursor matrix's segments staged contiguously."""
    runs = [_t(r) for r in _runs(13, (90,) * 57, ("dup", "dup", "u32"))]
    cmp_runs = [list(r) for r in runs]
    cursors = kway_kernel.kway_cursors(kway_kernel.kway_ranks(cmp_runs), 256)
    assert cursors.shape == (57, -(-57 * 90 // 256) + 1)
    counts = cursors[:, 1:] - cursors[:, :-1]
    assert counts.sum(0)[:-1].tolist() == [256] * (counts.shape[1] - 1)
    _assert_bits(kway_kernel.merge_runs_kway_kernel(runs),
                 kway_kernel.merge_runs_kway_take(runs))


def test_kway_kernel_refuses_more_runs_than_a_launch_takes():
    runs = [(torch.tensor([r], dtype=torch.int32),)
            for r in range(kway_kernel.MAX_RUNS + 1)]
    with pytest.raises(ValueError, match="at most"):
        kway_kernel.merge_runs_kway_kernel(runs)
    assert len(kway_kernel.merge_runs_kway_take(runs)[0]) == len(runs)


@pytest.mark.parametrize("fill", adversarial.FILLS)
@pytest.mark.parametrize("k", [2, 3, 8, 57])
def test_kway_split_and_merge_tree_on_adversarial_runs(k, fill):
    """``adversarial.kway_case`` runs (empty and one-element runs among
    them, sentinel bits, four values, NaN payloads and ±0): the plain split
    gives the oracle's cursors and the plain merge tree the take tier's
    bits, at blocks 128 and 256."""
    rng = np.random.default_rng([k, len(fill)])
    runs, codes = adversarial.kway_case(rng, 3, fill, k, 300)
    runs = [tuple(torch.from_numpy(x) for x in r) for r in runs]
    for block in (128, 256):
        cmp, data, cursors, got_codes = kway_kernel.kway_operands(
            runs, n_cmp=3, block=block)
        assert got_codes == codes
        oracle = kway_kernel.kway_cursors(kway_kernel.kway_ranks(
            [r[:3] for r in runs]), block)
        assert torch.equal(cursors, oracle)
        got = kway_kernel.kway_merge(cmp, data, cursors, codes, block)
        want = kway_kernel.merge_runs_kway_take(runs, n_cmp=3)
        _assert_bits(got, [lex.as_bits(w) for w in want])


def test_kway_operands_gather_every_lane_once():
    """The plain gather (a ``torch.cat`` a lane) holds the compare lanes
    and the data lanes of each run at its base; with ``n_cmp`` the compare
    lanes are the data's leading rows."""
    runs = [_t(r) for r in _runs(14, (7, 1, 12), ("i32", "u32", "dup"))]
    cmp, data, cursors, codes = kway_kernel.kway_operands(runs, n_cmp=2)
    assert data.shape == (3, 20) and cmp.data_ptr() == data.data_ptr()
    for lane in range(3):
        assert torch.equal(data[lane], torch.cat(
            [lex.as_bits(r[lane]) for r in runs]))
    assert codes == [lex.I32, lex.U32]
    packed = kway_kernel.kway_operands(runs)
    assert torch.equal(packed[1], data)
    assert packed[0].shape[1] == 20


# --- B5 and the two-run front-end ---------------------------------------------

_PAIR_CASES = [((96, 80), ("u32",)), ((120, 8), ("i32", "u32")),
               ((129, 100), ("dup", "dup", "sentinel")),
               ((1, 1), ("u32", "u32")), ((0, 96), ("u32",)),
               ((700, 513), ("sentinel", "u32", "i32"))]


@pytest.mark.parametrize("sizes,kinds", _PAIR_CASES)
@pytest.mark.parametrize("engine", ["lanes", "packed", "kernel", "kway"])
def test_merge_sorted_lex_matches_reference(sizes, kinds, engine):
    a, b = _runs(14, sizes, kinds)
    got = ops.merge_sorted_lex(_t(a), _t(b), engine=engine, block_size=128)
    want = rops.merge_sorted_lex(_j(a), _j(b), engine="packed")
    _assert_bits(got, want)


@pytest.mark.parametrize("sizes,n_cmp", [((200, 150), None), ((77, 260), 2)])
def test_runmerge_kernel_matches_the_interpreted_pallas_kernel(sizes, n_cmp):
    a, b = _runs(15, sizes, ("dup", "u32", "u32"))
    got = runmerge_kernel.merge_runs_lex_kernel(_t(a), _t(b), n_cmp=n_cmp,
                                                block=128)
    want = merge_runs_lex_pallas(_j(a), _j(b), n_cmp=n_cmp, block=128,
                                 interpret=True)
    _assert_bits(got, want)


@pytest.mark.parametrize("engine", ["packed", "kernel", "kway"])
def test_merge_sorted_lex_float_contract(engine):
    a, b = _runs(16, (300, 211), ("f32", "i32"))
    got = ops.merge_sorted_lex(_t(a), _t(b), engine=engine, block_size=128)
    _assert_contract(got, [a, b])
    _assert_bits(got, keypack.merge_take_packed(_t(a), _t(b)))


@pytest.mark.parametrize("block", [128, 256, 512])
def test_runmerge_split_covers_each_block_exactly(block):
    a, b = (_t(r) for r in _runs(17, (1000, 777), ("dup", "u32")))
    starts = runmerge_kernel.merge_path_starts(a, b, block)
    seg = (starts[:, 1:] - starts[:, :-1]).sum(0)
    assert seg[:-1].tolist() == [block] * (seg.shape[0] - 1)
    assert int(seg[-1]) == 1777 - block * (seg.shape[0] - 1)
    _assert_bits(runmerge_kernel.merge_runs_lex_kernel(a, b, block=block),
                 keypack.merge_take_packed(a, b))


def test_merge_sorted_key_only_matches_reference():
    a, b = _runs(18, (400, 300), ("sentinel",))
    for engine in ("packed", "kernel"):
        got = ops.merge_sorted(_t(a)[0], _t(b)[0], engine=engine)
        want = rops.merge_sorted(jnp.asarray(a[0]), jnp.asarray(b[0]),
                                 engine="packed")
        _assert_bits([got], [want])


def test_eighteen_array_tuple_merges_behind_nine_compare_lanes():
    """The extended shortlex tuple of 32-byte words: 9 compare lanes (2
    packed, 7 suffix) ahead of 9 data lanes, 18 arrays in all — more than a
    sort network takes (``lex.MAX_ARRAYS``), but the merge windows hold only
    the compare lanes and the index."""
    rng = np.random.default_rng(19)
    mv = (32,) + (None,) * 8
    runs = []
    for n in (300, 170, 90):
        data = [np.sort(rng.integers(1, 33, n)).astype(np.int32)] + [
            _lane(rng, "dup", n) for _ in range(8)]
        order = np.lexsort(tuple(reversed(data)))
        data = [np.ascontiguousarray(l[order]) for l in data]
        cmp = rkp.packed_cmp_lanes(_j(data), mv)
        runs.append([np.asarray(c) for c in cmp] + data)
    assert len(runs[0]) == 18
    want = rops.merge_runs_lex([_j(r) for r in runs], engine="take", n_cmp=9)
    for engine in ("take", "kernel"):
        _assert_bits(ops.merge_runs_lex([_t(r) for r in runs], engine=engine,
                                        n_cmp=9, block_size=128), want)
    for engine in ("packed", "kernel"):
        _assert_bits(ops.merge_sorted_lex(_t(runs[0]), _t(runs[1]),
                                          engine=engine, n_cmp=9),
                     rops.merge_sorted_lex(_j(runs[0]), _j(runs[1]),
                                           engine="packed", n_cmp=9))


# --- engine choice and argument checks ----------------------------------------

def test_auto_rules_send_cuda_runs_past_two_blocks_to_the_kernels():
    assert ops.choose_merge_engine(10_000, device="cpu") == "packed"
    assert ops.choose_merge_engine(512, device="cuda") == "packed"
    assert ops.choose_merge_engine(513, device="cuda") == "kernel"
    assert ops.choose_merge_engine(10, "lanes") == "lanes"
    assert ops.choose_kway_engine(10_000, device="cpu") == "take"
    assert ops.choose_kway_engine(513, device="cuda") == "kernel"
    assert ops.choose_kway_engine(513, "take", device="cuda") == "take"
    with pytest.raises(ValueError):
        ops.choose_merge_engine(10, "bogus")
    with pytest.raises(ValueError):
        ops.choose_kway_engine(10, "packed")


def test_merge_front_ends_check_their_arguments():
    a = _t(_runs(20, (10,), ("u32", "u32"))[0])
    with pytest.raises(ValueError, match="arity"):
        ops.merge_sorted_lex(a, a[:1])
    with pytest.raises(ValueError, match="arity"):
        ops.merge_runs_lex([a, a[:1]])
    with pytest.raises(ValueError, match="power of two"):
        runmerge_kernel.merge_runs_lex_kernel(a, a, block=200)
    with pytest.raises(ValueError, match="power of two"):
        kway_kernel.merge_runs_kway_kernel([a, a], block=64)
    wide = tuple(torch.arange(10, dtype=torch.int32) for _ in range(16))
    with pytest.raises(ValueError, match="compare lanes"):
        runmerge_kernel.merge_runs_lex_kernel(wide, wide, n_cmp=16)
    empty = tuple(x[:0] for x in a)
    assert ops.merge_sorted_lex(empty, a, engine="kernel") == a
    assert ops.merge_runs_lex([empty, a, empty], engine="kernel") == a


def test_float_ties_fall_as_the_reference_take_tier_not_its_kernel():
    """Key-only float32 runs of ±0.0 and NaNs of several payloads: the
    reference's own engines order these ties differently (its take tier is
    a stable sort, its interpreted kernel a network), so float lanes are
    held to the contract and never to one engine. The port's kernel carries
    a source index, so its ties fall as the stable merge — the reference's
    take tier, bit for bit."""
    rng = np.random.default_rng(21)
    pats = np.array([0x7FC00000, 0x7FC00001, 0xFFC00000, 0x7F800001],
                    np.uint32).view(np.float32)
    runs = []
    for n in (150, 170, 80):
        f = rng.normal(size=n).astype(np.float32)
        pick = rng.random(n)
        f[pick < 0.2] = -0.0
        f[(pick >= 0.2) & (pick < 0.4)] = 0.0
        m = pick >= 0.8
        f[m] = pats[rng.integers(0, len(pats), int(m.sum()))]
        runs.append([f[np.argsort(order_bits_view(f), kind="stable")]])
    ref_take = rops.merge_runs_lex([_j(r) for r in runs], engine="take")
    ref_kernel = rops.merge_runs_lex([_j(r) for r in runs], engine="kernel",
                                     block_size=128, interpret=True)
    differ = int((_bits(ref_take[0]) != _bits(ref_kernel[0])).sum())
    assert differ > 0, "the reference's engines agree on float ties"
    _assert_contract(ref_kernel, runs)
    got = ops.merge_runs_lex([_t(r) for r in runs], engine="kernel",
                             block_size=128)
    _assert_bits(got, ref_take)
    _assert_contract(got, runs)


# --- the k-way front ends past one launch of the k-way kernel ---------------

@pytest.fixture(scope="module")
def runs_past_one_launch():
    """``kway_kernel.MAX_RUNS + 1`` one-element runs of two int32 lanes (a
    key with ties across runs, and the run's index), and the reference's
    ``merge_runs(engine='auto')`` of them."""
    rng = np.random.default_rng(23)
    n = kway_kernel.MAX_RUNS + 1
    keys = rng.integers(-40, 40, n).astype(np.int32)
    runs = [(keys[r:r + 1], np.array([r], np.int32)) for r in range(n)]
    return runs, ref_merge_runs([_j(r) for r in runs], engine="auto")


def test_kway_auto_takes_the_take_tier_past_one_launch():
    big = kway_kernel.MAX_RUNS
    assert ops.choose_kway_engine(10_000, device="cuda",
                                  n_runs=big) == "kernel"
    assert ops.choose_kway_engine(10_000, device="cuda",
                                  n_runs=big + 1) == "take"
    assert ops.choose_kway_engine(10_000, "kernel", device="cuda",
                                  n_runs=big + 1) == "kernel"


@pytest.mark.parametrize("front", ["ops.merge_runs_lex auto",
                                   "merge_runs auto", "merge_runs kway"])
def test_kway_front_ends_merge_past_one_launch_on_the_cards_routing(
        runs_past_one_launch, monkeypatch, front):
    """With the card's routing (``ops._on_cuda`` true), the front ends of
    one k-way pass route 1025 runs to the 'take' tier and return the
    reference's merge; the kernel's own refusal stays
    (``test_kway_kernel_refuses_more_runs_than_a_launch_takes``)."""
    monkeypatch.setattr(ops, "_on_cuda", lambda device: True)
    runs, want = runs_past_one_launch
    runs = [_t(r) for r in runs]
    if front == "ops.merge_runs_lex auto":
        got = ops.merge_runs_lex(runs, engine="auto")
    else:
        got = merge_runs(runs, engine=front.split()[1])
    _assert_bits(got, want)
