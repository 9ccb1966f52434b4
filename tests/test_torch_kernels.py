"""Each kernel's plain PyTorch version against the reference Pallas kernel,
run in interpret mode as ``tests/test_kernels.py`` runs it. The port's
networks are the reference's — the same compare-exchange pairs and the same
strict compare — so the bits agree exactly, NaN and ±0.0 ties included.
The CUDA kernels themselves are held against these plain versions on the
card (``tests/test_torch_gpu.py``, ``chip_smoke.py``)."""

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
from repro_torch.kernels import (bitonic_kernel, distribute_kernel, lex,
                                 merge_kernel, oets_kernel)

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
                 lambda: merge_kernel.merge_adjacent_lex(x, codes, block=64)):
        with pytest.raises(ValueError):
            call()


def test_no_kernel_launch_on_the_cpu():
    """A CPU tensor runs the plain version: the launch counters stay put."""
    before = {k.name: k.launches for k in (oets_kernel.KERNEL,
                                           bitonic_kernel.KERNEL)}
    x, codes = _stack(_lanes("words_u32x4", 2, 128))
    oets_kernel.oets_rows_lex(x.clone(), codes)
    bitonic_kernel.bitonic_rows_lex(x.clone(), codes)
    assert before == {k.name: k.launches for k in (oets_kernel.KERNEL,
                                                   bitonic_kernel.KERNEL)}


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
