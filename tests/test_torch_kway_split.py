"""The port's k-way split and k-way merge (B6, ``kway_kernel``) on the CPU,
where both run their plain versions: the split's rounds
(``kway_starts``, pair by pair through B5's plain split and merge) against
the torch oracle (``kway_cursors(kway_ranks(...))``) and against cursors
built from the reference's ``kway_ranks``, bit for bit; the merge tree of
``kway_merge_plain`` against the torch tier ``merge_runs_kway_take``; and
the host plan of the split's rounds."""

import functools
import math
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.kway_kernel import kway_ranks as ref_kway_ranks
from repro.pipeline.validate import order_bits_view
from repro_torch.interop import to_device
from repro_torch.kernels import adversarial, kway_kernel, lex
from repro_torch.kernels.runmerge_kernel import cmp_codes, stack_lanes


def _lane(rng, kind, n):
    if kind == "f32":
        f = rng.normal(scale=10.0, size=n).astype(np.float32)
        pick = rng.random(n)
        f[pick < 0.15] = np.nan
        f[(pick >= 0.15) & (pick < 0.3)] = -0.0
        f[(pick >= 0.3) & (pick < 0.45)] = 0.0
        pats = np.array([0x7FC00001, 0xFFC00000, 0x7F800001, 0xFFFFFFFF],
                        np.uint32).view(np.float32)
        m = pick >= 0.9
        f[m] = pats[rng.integers(0, len(pats), int(m.sum()))]
        return f
    if kind == "i32":
        return rng.integers(-2**31, 2**31, n).astype(np.int32)
    if kind == "dup":
        return rng.integers(0, 3, n).astype(np.uint32)
    if kind == "equal":
        return np.full(n, 7, np.uint32)
    v = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    v[rng.random(n) < 0.3] = 0xFFFFFFFF
    return v


def _key(lane):
    if lane.dtype == np.float32:
        return order_bits_view(lane)
    if lane.dtype == np.int32:
        return lane.view(np.uint32) ^ np.uint32(0x80000000)
    return lane


def _sorted_run(rng, n, kinds):
    lanes = [_lane(rng, k, n) for k in kinds]
    order = np.lexsort(tuple(_key(l) for l in reversed(lanes)))
    return [np.ascontiguousarray(l[order]) for l in lanes]


# equal run lengths keep the reference's eager split to a few shapes
_EDGY = [0 if r in (3, 40) else 1 if r in (10, 25) else 20 for r in range(64)]


@functools.lru_cache(maxsize=None)
def _case(name):
    """``(runs, codes)``: sorted runs as lists of numpy lanes, every lane
    a compare lane, for the case ``name``: k runs with empty ones and runs
    of one element, ``MAX_RUNS`` runs, every key equal, one run wholly
    below the rest, float lanes of NaN payloads and ±0, and each co-rank
    edge of ``adversarial.MERGE_EDGES``."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    sizes = {"k=2": (45, 1), "k=3": (20, 0, 33), "k=5": (20, 1, 20, 0, 20),
             "k=8": (20, 20, 0, 20, 1, 20, 20, 20), "k=57": _EDGY[:57],
             "k=64": _EDGY, "max_runs": (1,) * kway_kernel.MAX_RUNS,
             "all_equal": (20, 0, 20, 1, 20), "one_run_below": (20, 20, 20),
             "float": (40, 0, 40, 1)}
    kinds = {"k=2": ("sentinel",), "k=3": ("sentinel", "i32"),
             "all_equal": ("equal",), "float": ("f32", "i32")}
    if name.startswith("edge:"):
        # one uint32 lane: the reference's one-lane split searches floats
        # as floats (every NaN equal), its multi-lane split by order bits,
        # so float NaN payloads are held in the two-lane 'float' case
        a, b, codes = adversarial.merge_case(rng, 1, "sentinel", name[5:])
        return [[a[0].view(np.uint32)], [b[0].view(np.uint32)]], codes
    runs = [_sorted_run(rng, n, kinds.get(name, ("dup",)))
            for n in sizes[name]]
    if name == "one_run_below":
        runs[1][0] = np.sort(rng.integers(0, 5, 20)).astype(np.uint32)
        for r in (0, 2):
            runs[r][0] = np.sort(rng.integers(1000, 2000, 20)).astype(
                np.uint32)
    return runs, cmp_codes([to_device(l, "cpu") for l in runs[0]])


_CASES = ["k=2", "k=3", "k=5", "k=8", "k=57", "k=64", "max_runs",
          "all_equal", "one_run_below", "float"] + [
              f"edge:{e}" for e in adversarial.MERGE_EDGES]


def _stack(runs):
    """The runs' lanes concatenated as stacked int32 bits, and their
    lengths."""
    ns = [len(r[0]) for r in runs]
    flat = [np.concatenate([r[l] for r in runs]) for l in range(len(runs[0]))]
    return stack_lanes([to_device(x, "cpu") for x in flat]).contiguous(), ns


@functools.lru_cache(maxsize=None)
def _ref_ranks(name):
    """The reference's ``kway_ranks`` of the case's non-empty runs (its
    callers drop the empty ones)."""
    runs = [r for r in _case(name)[0] if len(r[0])]
    return [np.asarray(x) for x in
            ref_kway_ranks([[jnp.asarray(l) for l in r] for r in runs])]


def _ref_cursors(name, block):
    """Cursors from the reference's ``kway_ranks``: one ``np.searchsorted``
    a non-empty run over the block bounds, at the run's unpadded base."""
    runs = [r for r in _case(name)[0] if len(r[0])]
    ranks = _ref_ranks(name)
    total = sum(len(r[0]) for r in runs)
    bounds = np.arange(-(-total // block) + 1) * block
    base, rows = 0, []
    for r, rank in zip(runs, ranks):
        rows.append(base + np.searchsorted(rank, bounds, side="left"))
        base += len(r[0])
    return np.stack(rows).astype(np.int32)


@pytest.mark.parametrize("block", [128, 256])
@pytest.mark.parametrize("name", _CASES)
def test_kway_starts_match_the_oracle_and_the_reference(name, block):
    runs, codes = _case(name)
    cmp, ns = _stack(runs)
    got = kway_kernel.kway_starts(cmp, ns, codes, block)
    oracle = kway_kernel.kway_cursors(kway_kernel.kway_ranks(
        [[to_device(l, "cpu") for l in r] for r in runs]), block)
    assert got.dtype == torch.int32
    assert got.shape == (len(ns), -(-sum(ns) // block) + 1)
    np.testing.assert_array_equal(got.numpy(), oracle.numpy())
    # the empty runs' rows repeat their neighbours' bases
    keep = [i for i, n in enumerate(ns) if n]
    np.testing.assert_array_equal(got.numpy()[keep],
                                  _ref_cursors(name, block))


@pytest.mark.parametrize("block", [128, 256])
@pytest.mark.parametrize("name", _CASES)
def test_kway_merge_tree_is_the_take_tier(name, block):
    runs, _ = _case(name)
    runs = [tuple(to_device(l, "cpu") for l in r) for r in runs]
    nonempty = [r for r in runs if r[0].shape[0]]
    cmp, data, cursors, codes = kway_kernel.kway_operands(nonempty,
                                                          block=block)
    got = kway_kernel.kway_merge_plain(cmp, data, cursors, codes, block)
    want = kway_kernel.merge_runs_kway_take(nonempty)
    assert got.shape == (len(want), sum(r[0].shape[0] for r in nonempty))
    for g, w in zip(got, want):
        assert torch.equal(g, lex.as_bits(w))


def test_kway_merge_tree_keeps_run_order_on_ties():
    """Equal keys from three runs: the merge tree takes the lower run's
    first, within a block and across the blocks' segments."""
    runs = [(torch.full((n,), 5, dtype=torch.int32),
             torch.full((n,), r, dtype=torch.int32))
            for r, n in enumerate((130, 200, 90))]
    cmp, data, cursors, codes = kway_kernel.kway_operands(runs, n_cmp=1,
                                                          block=128)
    got = kway_kernel.kway_merge_plain(cmp, data, cursors, codes, 128)
    assert got[1].tolist() == [0] * 130 + [1] * 200 + [2] * 90


def test_split_plan_pairs_offsets_tail_and_block_prefix():
    rounds = kway_kernel.split_plan([3, 0, 5, 2, 7], block=4)
    assert [rd.pairs for rd in rounds] == [
        ((0, 3, 0), (3, 5, 2), (10, 7, 0)),      # the odd tail: nb = 0
        ((0, 3, 7), (10, 7, 0)),
        ((0, 10, 7),)]
    assert [rd.first for rd in rounds] == [(0, 1, 3, 5), (0, 3, 5), (0, 5)]


def test_split_plan_of_one_run_copies_it_once():
    assert kway_kernel.split_plan([9], block=4) == [
        kway_kernel.SplitRound(((0, 9, 0),), (0, 3))]


@pytest.mark.parametrize("k", [1, 2, 3, 5, 8, 57, 64, 257, 1024])
def test_split_plan_rounds_cover_the_runs(k):
    """ceil(log2 k) rounds (one for a single run), each of adjacent pairs
    laid end to end over ``[0, total)``, each pair's blocks ``ceil((na +
    nb) / block)`` in the prefix ``first``."""
    rng = np.random.default_rng(k)
    ns = [int(n) for n in rng.integers(0, 700, k)]
    rounds = kway_kernel.split_plan(ns)
    assert len(rounds) == max(1, math.ceil(math.log2(k)))
    segs = len(ns)
    for rd in rounds:
        assert len(rd.pairs) == -(-segs // 2)
        at = 0
        for (off, na, nb), lo, hi in zip(rd.pairs, rd.first, rd.first[1:]):
            assert off == at
            at += na + nb
            assert hi - lo == -(-(na + nb) // kway_kernel.SPLIT_BLOCK)
        assert at == sum(ns) and rd.first[0] == 0
        if segs % 2:
            assert rd.pairs[-1][2] == 0
        segs = len(rd.pairs)
    assert segs == 1


def test_kway_starts_checks_its_arguments():
    cmp = torch.zeros((2, 10), dtype=torch.int32)
    with pytest.raises(ValueError, match="add up"):
        kway_kernel.kway_starts(cmp, [4, 5], [lex.U32] * 2, 128)
    with pytest.raises(ValueError, match="code each"):
        kway_kernel.kway_starts(cmp, [4, 6], [lex.U32], 128)
    with pytest.raises(ValueError, match="contiguous"):
        kway_kernel.kway_starts(cmp.T.contiguous().T, [4, 6],
                                [lex.U32] * 2, 128)
