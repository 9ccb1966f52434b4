"""Each kernel's plain PyTorch version against the reference Pallas kernel,
run in interpret mode as ``tests/test_kernels.py`` runs it. The port's
networks are the reference's — the same compare-exchange pairs and the same
strict compare — so the bits agree exactly, NaN and ±0.0 ties included.
The CUDA kernels themselves are held against these plain versions on the
card (``tests/test_torch_gpu.py``, ``chip_smoke.py``)."""

import math
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.bitonic_kernel import bitonic_rows_lex_pallas
from repro.kernels.distribute_kernel import distribute_rows_pallas
from repro.kernels.merge_kernel import merge_adjacent_lex_pallas
from repro.kernels.oets_kernel import oets_rows_lex_pallas
from repro.testing.generators import fill_elements, make_words
from repro.core.packing import pack_words
from repro_torch.kernels import (adversarial, bitonic_kernel,
                                 distribute_kernel, lex, merge_kernel,
                                 oets_kernel)
from repro_torch.kernels.lex import from_bits
from repro_torch.pipeline.validate import check_lanes_sorted

_NP_CODE = {np.dtype(np.uint32): lex.U32, np.dtype(np.int32): lex.I32,
            np.dtype(np.float32): lex.F32}

# lane sets: the main path's four uint32 word lanes on sentinel-colliding
# data, and a float32 NaN / ±0 mix with an int32 tie lane and a payload
_LANE_SETS = {
    "words_u32x4": [("sentinel", np.uint32)] * 4,
    "nan_f32_i32_payload": [("nan", np.float32), ("dup_heavy", np.int32),
                            ("nan", np.float32), ("random", np.int32)],
}
# the widths B2's kernel splits on: one and nine lanes, integer and float
_BITONIC_LANE_SETS = {
    **_LANE_SETS,
    "one_i32": [("sentinel", np.int32)],
    "nine_mixed": [("nan", np.float32), ("sentinel", np.uint32),
                   ("dup_heavy", np.int32)] * 3,
}


def _lanes(name: str, rows: int, cols: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    return [fill_elements(gen, rng, rows * cols, dt).reshape(rows, cols)
            for gen, dt in _BITONIC_LANE_SETS[name]]


def _stack(lanes):
    """numpy lanes -> the port's stacked int32 tensor and codes."""
    x = torch.from_numpy(np.stack([a.view(np.int32) for a in lanes]))
    return x.contiguous(), [_NP_CODE[a.dtype] for a in lanes]


def _assert_bits(got: torch.Tensor, want_lanes):
    want = np.stack([np.asarray(w).view(np.uint32) for w in want_lanes])
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


@pytest.mark.parametrize("lane_set", sorted(_LANE_SETS))
def test_oets_plain_matches_pallas(lane_set):
    lanes = _lanes(lane_set, 8, 128)
    x, codes = _stack(lanes)
    got = oets_kernel.oets_rows_lex(x.clone(), codes)   # CPU -> plain version
    want = oets_rows_lex_pallas(*[jnp.asarray(a) for a in lanes],
                                interpret=True)
    _assert_bits(got, want)


@pytest.mark.parametrize("lane_set,cols", [
    *[pytest.param(name, 128, id=name) for name in sorted(_LANE_SETS)],
    *[pytest.param(name, cols, id=f"{name}-{cols}")
      for name, cols in (("one_i32", 128), ("nine_mixed", 128),
                         ("one_i32", 256), ("words_u32x4", 256),
                         ("one_i32", 1024))]])
def test_bitonic_plain_matches_pallas(lane_set, cols):
    """Rows of 128 (B2's register-only kernel), 256 and 1024 columns (its
    shared-memory stages), at one, four and nine lanes; the reference's
    interpreted network costs seconds per lane and width here, so the wide
    and the nine-lane rows are not crossed."""
    lanes = _lanes(lane_set, 8, cols, seed=1)
    x, codes = _stack(lanes)
    got = bitonic_kernel.bitonic_rows_lex(x.clone(), codes)
    want = bitonic_rows_lex_pallas(*[jnp.asarray(a) for a in lanes],
                                   interpret=True)
    _assert_bits(got, want)


@pytest.mark.parametrize("lane_set", sorted(_LANE_SETS))
def test_merge_plain_matches_pallas(lane_set):
    """Block 128: sorted 128-blocks (by the port's bitonic), two pairs a
    row; the reference merges the same input."""
    block = 128
    lanes = _lanes(lane_set, 8, 4 * block, seed=2)
    x, codes = _stack(lanes)
    bitonic_kernel.bitonic_rows_lex(x.view(len(lanes), -1, block), codes)
    sorted_blocks = [x[a].numpy().view(l.dtype) for a, l in enumerate(lanes)]
    got = merge_kernel.merge_adjacent_lex(x.clone(), codes, block=block)
    want = merge_adjacent_lex_pallas(*[jnp.asarray(a) for a in sorted_blocks],
                                     block=block, interpret=True)
    _assert_bits(got, want)


def test_merge_at_an_offset_touches_only_its_pairs():
    """The odd round merges in place from column ``lo``; the edge blocks
    stay as they were (the reference concatenates them back)."""
    block = 128
    lanes = _lanes("words_u32x4", 3, 4 * block, seed=3)
    x, codes = _stack(lanes)
    bitonic_kernel.bitonic_rows_lex(x.view(4, -1, block), codes)
    before = x.clone()
    merge_kernel.merge_adjacent_lex(x, codes, block=block, lo=block, npairs=1)
    assert torch.equal(x[..., :block], before[..., :block])
    assert torch.equal(x[..., 3 * block:], before[..., 3 * block:])
    mid = merge_kernel.merge_network_plain(before[..., block:3 * block],
                                           codes, block)
    assert torch.equal(x[..., block:3 * block], mid)


# blocksort's merge-path rounds: lane codes at 1, 2, 4 and 9 lanes
_PAIR_CODES = {1: [lex.I32], 2: [lex.U32, lex.I32], 4: [lex.U32] * 4,
               9: [lex.U32, lex.I32] * 4 + [lex.U32]}


def _pair_input(seed, codes, rows, ncols, run):
    """Rows of ``run``-wide sorted runs: duplicate-heavy lanes (ties across
    runs, on every lane), a fifth of the words the code's sentinel, row 0
    wholly sentinel."""
    rng = np.random.default_rng(seed)
    x = np.stack([adversarial.lane_bits(rng, (rows, ncols), c, "dup_heavy")
                  for c in codes])
    pad = rng.random((rows, ncols)) < 0.2
    for a, c in enumerate(codes):
        x[a][pad] = lex.sentinel_bits(c)
        x[a, 0] = lex.sentinel_bits(c)
    return _stable_rounds_oracle(torch.from_numpy(x), codes, run // 2)


def _stable_rounds_oracle(x, codes, run):
    """numpy's stable ``lexsort`` of every ``2 run``-wide window of every
    row (the last cut at the row's end) over the lanes' order keys."""
    keys = lex.order_keys(x, codes).numpy()
    out = x.numpy().copy()
    width = 2 * run
    for r in range(x.shape[1]):
        for lo in range(0, x.shape[2], width):
            hi = min(lo + width, x.shape[2])
            perm = np.lexsort(keys[::-1, r, lo:hi])
            out[:, r, lo:hi] = out[:, r, lo:hi][:, perm]
    return torch.from_numpy(out)


@pytest.mark.parametrize("lanes", sorted(_PAIR_CODES))
@pytest.mark.parametrize("nb", [2, 3, 5, 7, 8])
def test_merge_pairs_plain_is_the_stable_merge(nb, lanes):
    """Every round from runs of 16 up, the last run 5 short: the plain
    merge is numpy's stable lexsort of each pair window, a last run with no
    partner copied; after ``ceil(log2 nb)`` rounds each row is sorted."""
    codes = _PAIR_CODES[lanes]
    run = 16
    x = _pair_input(nb * 10 + lanes, codes, 3, nb * run - 5, run)
    rounds = 0
    while run < x.shape[2]:
        y = torch.empty_like(x)
        got = merge_kernel.merge_pairs_lex(x, y, codes, run=run)
        assert got is y
        assert torch.equal(y, _stable_rounds_oracle(x, codes, run))
        x, run, rounds = y, run * 2, rounds + 1
    assert rounds == math.ceil(math.log2(nb))
    keys = lex.order_keys(x, codes).numpy()
    for r in range(x.shape[1]):
        perm = np.lexsort(keys[::-1, r])
        assert np.array_equal(perm, np.arange(x.shape[2]))


def test_merge_pairs_plain_float_ties_follow_the_order_bits():
    """Float lanes of NaN payloads, -0.0 and +0.0, and an int32 tie lane:
    a round keeps each window's tuples bit for bit and sorts them under the
    order bits."""
    codes = [lex.F32, lex.I32, lex.F32]
    rng = np.random.default_rng(5)
    x = torch.from_numpy(np.stack([
        adversarial.lane_bits(rng, (4, 5 * 64), c, "nan") for c in codes]))
    x = merge_kernel.merge_pairs_plain(x, codes, 32)      # sorted 64-runs
    for run in (64, 128, 256):
        y = merge_kernel.merge_pairs_lex(x, torch.empty_like(x), codes,
                                         run=run)
        for r in range(x.shape[1]):
            for lo in range(0, x.shape[2], 2 * run):
                win = slice(lo, lo + 2 * run)
                assert sorted(map(tuple, x[:, r, win].T.tolist())) == \
                    sorted(map(tuple, y[:, r, win].T.tolist()))
                check_lanes_sorted([from_bits(y[a, r, win], _F32_OR_I32[c])
                                    for a, c in enumerate(codes)],
                                   what="merge_pairs_lex")
        x = y


_F32_OR_I32 = {lex.F32: torch.float32, lex.I32: torch.int32}


@pytest.mark.parametrize("nb", [2, 3, 5, 7, 8, 40])
def test_blocksort_makes_ceil_log2_nb_rounds(nb):
    """``blocksort.rounds`` counts ``ceil(log2 nb)`` merge rounds a call,
    and the rows agree with ``numpy.lexsort``: 128-column blocks, the last
    one partial, three rows of a kv pair."""
    from repro_torch.core.blocksort import block_sort_kv
    from repro_torch.runtime import trace
    rng = np.random.default_rng(nb)
    n = nb * 128 - 5
    k = rng.integers(-3, 3, (3, n)).astype(np.int32)
    v = rng.integers(0, 1 << 32, (3, n), dtype=np.uint64).astype(np.uint32)
    trace.clear()
    with trace.recording():
        gk, gv = block_sort_kv(torch.from_numpy(k), torch.from_numpy(v),
                               block_size=128)
    assert trace.counters() == {"blocksort.rounds": math.ceil(math.log2(nb))}
    trace.clear()
    for r in range(3):
        perm = np.lexsort((v[r], k[r]))
        np.testing.assert_array_equal(gk[r].numpy(), k[r][perm])
        np.testing.assert_array_equal(gv[r].numpy(), v[r][perm])


def _distribute_words(kind: str):
    rng = np.random.default_rng(7)
    if kind == "random":
        words = [w for _ in range(4) for w in make_words("random", rng)][:300]
        return pack_words(words, width=8)
    if kind == "one_length":
        # every word in one bucket, interior NUL bytes included
        words = [bytes(rng.integers(0, 256, 6, dtype=np.uint8)) + b"z"
                 for _ in range(300)]
        return pack_words(words, width=8)
    # 0xFF bytes (lanes equal to the uint32 sentinel), interior NUL bytes,
    # empty words, at 4 lanes
    words = make_words("sentinel", rng, max_len=16) * 3
    words += [b"a\x00b", b"\x00\x00\x00x", b"", b"abcd\x00\x00\x00\x01"] * 6
    return pack_words(words[:300], width=16)


@pytest.mark.parametrize("kind,n_valid", [
    pytest.param("random", 300, id="random"),
    pytest.param("sentinel_nul", 300, id="sentinel_nul"),
    pytest.param("one_length", 300, id="one_length"),
    pytest.param("random", 0, id="random-none_valid")])
def test_distribute_plain_matches_pallas(kind, n_valid):
    """300 words: three 128-column grid steps in the reference, so its
    running counts carry across blocks; the padded tail gets the discard
    id."""
    keys = _distribute_words(kind)
    n, lanes = keys.shape
    assert n == 300
    n_pad = 384
    padded = np.zeros((n_pad, lanes), np.uint32)
    padded[:n] = keys
    nb = 4 * lanes + 1
    dest, rank, counts = distribute_kernel.distribute_rows(
        torch.from_numpy(padded.view(np.int32)), n_valid=n_valid)
    rd, rr, rc = distribute_rows_pallas(jnp.asarray(padded.T),
                                        n_valid=n_valid, num_buckets=nb,
                                        interpret=True)
    np.testing.assert_array_equal(dest.numpy(), np.asarray(rd)[0])
    np.testing.assert_array_equal(rank.numpy(), np.asarray(rr)[0])
    np.testing.assert_array_equal(counts.numpy(), np.asarray(rc)[0, :nb])


@pytest.mark.parametrize("bad", ["dtype", "codes", "too_many", "device"])
def test_wrappers_reject_what_the_kernels_do_not_take(bad):
    x = torch.zeros((2, 3, 128), dtype=torch.int32)
    codes = [lex.U32, lex.U32]
    if bad == "dtype":
        x = x.to(torch.int64)
    elif bad == "codes":
        codes = [lex.U32]
    elif bad == "too_many":
        x = torch.zeros((10, 3, 128), dtype=torch.int32)
        codes = [lex.U32] * 10
    else:
        x = x.to("meta")
    for call in (lambda: oets_kernel.oets_rows_lex(x, codes),
                 lambda: bitonic_kernel.bitonic_rows_lex(x, codes),
                 lambda: merge_kernel.merge_adjacent_lex(x, codes, block=64),
                 lambda: merge_kernel.merge_pairs_lex(
                     x, torch.empty_like(x), codes, run=64)):
        with pytest.raises(ValueError):
            call()


def test_no_kernel_launch_on_the_cpu():
    """A CPU tensor runs the plain version: the launch counters stay put."""
    kernels = (oets_kernel.KERNEL, bitonic_kernel.KERNEL,
               merge_kernel.PAIRS_KERNEL)
    before = {k.name: k.launches for k in kernels}
    x, codes = _stack(_lanes("words_u32x4", 2, 128))
    oets_kernel.oets_rows_lex(x.clone(), codes)
    bitonic_kernel.bitonic_rows_lex(x.clone(), codes)
    merge_kernel.merge_pairs_lex(x, torch.empty_like(x), codes, run=64)
    assert before == {k.name: k.launches for k in kernels}


def test_merge_block_cap_from_shared_memory():
    """2 B x arrays x 4 bytes <= 227 KB: 4096 at four lanes, 16384 alone."""
    assert merge_kernel.max_merge_block(4) == 4096
    assert merge_kernel.max_merge_block(5) == 4096
    assert merge_kernel.max_merge_block(1) == 16384
    assert merge_kernel.max_merge_block(9) == 2048


def test_library_name_follows_every_header(tmp_path, monkeypatch):
    """A library is named by a hash of its source and of every header under
    ``csrc/``: an edit to a header other than ``common.cuh`` (here the
    networks' ``network.cuh``) names a new library, so a stale build is
    never reused; an unedited copy names the same one."""
    from repro_torch.kernels import _build
    here = {s: _build._lib_path(s) for s in _build.SOURCES}
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    assert {s: _build._lib_path(s) for s in _build.SOURCES} == here
    header = csrc / "network.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    edited = {s: _build._lib_path(s) for s in _build.SOURCES}
    assert all(edited[s] != here[s] for s in _build.SOURCES)
