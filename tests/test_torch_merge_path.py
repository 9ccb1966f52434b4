"""B5's diagonal split and merge against the reference, on the CPU (the
kernels' plain versions), at the co-rank edges of a two-run merge
(``adversarial.MERGE_EDGES``: empty runs and runs of one element, equal
runs, one run wholly below the other, totals on and off a block multiple)
over the adversarial fills (the sentinel tuple as a real value, heavy
duplicates, float lanes of NaN payloads and ±0).

The split is held to the reference's jnp split, recomputed here as
``src/repro/kernels/runmerge_kernel.py:110-114`` computes it inside its
jit: ``keypack.lex_searchsorted`` ranks of a against b, then one
``jnp.searchsorted`` over the block bounds. A float lane ranks on its
canonical order bits (``lex.to_order_bits``), as every float lane reaches
the reference's merges (through ``packed_cmp_lanes``); its single-lane
``jnp.searchsorted`` on raw floats would order NaN payloads otherwise."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import keypack as rkp
from repro.kernels import lex as rlex
from repro.kernels import ops as rops
from repro_torch.kernels import adversarial, lex, runmerge_kernel

_TYPES = {lex.U32: np.uint32, lex.I32: np.int32, lex.F32: np.float32}
_CASES = [("sentinel", 1), ("sentinel", 3), ("dup_heavy", 2), ("nan", 1),
          ("nan", 2)]


def _case(fill, n_cmp, edge):
    rng = np.random.default_rng([n_cmp, len(fill), len(edge)])
    a, b, codes = adversarial.merge_case(rng, n_cmp, fill, edge)
    codes = codes + [lex.I32, lex.I32]
    typed = [[l.view(_TYPES[c]) for l, c in zip(r, codes)] for r in (a, b)]
    return typed, n_cmp


def _reference_split(cmp_a, cmp_b, block):
    cmp_a = [rlex.to_order_bits(jnp.asarray(x)) for x in cmp_a]
    cmp_b = [rlex.to_order_bits(jnp.asarray(x)) for x in cmp_b]
    na, nb = cmp_a[0].shape[0], cmp_b[0].shape[0]
    nblocks = -(-(na + nb) // block)
    rank_a = jnp.arange(na, dtype=jnp.int32) + rkp.lex_searchsorted(
        cmp_b, cmp_a, side="left").astype(jnp.int32)
    bounds = jnp.arange(nblocks + 1, dtype=jnp.int32) * block
    a_starts = jnp.searchsorted(rank_a, bounds, side="left").astype(jnp.int32)
    b_starts = jnp.clip(bounds - a_starts, 0, nb).astype(jnp.int32)
    return np.stack([np.asarray(a_starts), np.asarray(b_starts)])


@pytest.mark.parametrize("block", [128, 256, 1024])
@pytest.mark.parametrize("edge", list(adversarial.MERGE_EDGES))
@pytest.mark.parametrize("fill,n_cmp", _CASES)
def test_merge_path_starts_match_the_reference_split(fill, n_cmp, edge,
                                                     block):
    (a, b), n_cmp = _case(fill, n_cmp, edge)
    want = _reference_split(a[:n_cmp], b[:n_cmp], block)
    cmp_a = [torch.from_numpy(x) for x in a[:n_cmp]]
    cmp_b = [torch.from_numpy(x) for x in b[:n_cmp]]
    got = runmerge_kernel.merge_path_starts(cmp_a, cmp_b, block)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # the stacked form, as merge_operands hands it over
    codes = runmerge_kernel.cmp_codes(cmp_a)
    stacked = runmerge_kernel.merge_path_starts(
        runmerge_kernel.stack_lanes(cmp_a), runmerge_kernel.stack_lanes(cmp_b),
        block, codes)
    np.testing.assert_array_equal(stacked.numpy(), want)


@pytest.mark.parametrize("edge", list(adversarial.MERGE_EDGES))
@pytest.mark.parametrize("fill,n_cmp", _CASES)
def test_runmerge_at_the_co_rank_edges_matches_the_reference(fill, n_cmp,
                                                             edge):
    """The merge of the same runs at block 128 (the plain version): the
    reference's packed merge over the same leading compare lanes, bit for
    bit; the payload lanes show every tie kept a before b, in run order."""
    (a, b), n_cmp = _case(fill, n_cmp, edge)
    ta = tuple(torch.from_numpy(x) for x in a)
    tb = tuple(torch.from_numpy(x) for x in b)
    ops = runmerge_kernel.merge_operands(ta, tb, n_cmp, block=128)
    got = runmerge_kernel.runmerge(*ops, 128)
    ext = [tuple(rlex.to_order_bits(jnp.asarray(x)) for x in r[:n_cmp])
           + tuple(jnp.asarray(x) for x in r) for r in (a, b)]
    want = rops.merge_sorted_lex(*ext, engine="packed", n_cmp=n_cmp)
    want = np.stack([np.asarray(w).view(np.int32) for w in want[n_cmp:]])
    np.testing.assert_array_equal(got.numpy(), want)
