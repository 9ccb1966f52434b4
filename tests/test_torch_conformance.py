"""The port's conformance matrix (``repro_torch.testing``) on the CPU, held
against the reference's kit (``repro.testing``).

Every cell of the port's matrix in ``torch-cpu`` must conform to the port's
NumPy oracle; each case's arrays and each oracle's outputs must equal the
reference's for the same ``(op, gen, dtype)`` byte for byte; the
``random`` case of every ``(op, engine)`` must give the reference op's
outputs bit for bit in its eager ``interpret-cpu`` mode (the reference op
runs only there, not in every cell: its own matrix file takes minutes);
and the matrix, per mode, is no smaller than the reference's.
"""

import numpy as np
import pytest

from repro.testing import CONTRACTS as REF_CONTRACTS
from repro.testing import available_modes as ref_available_modes
from repro.testing import iter_matrix as ref_iter_matrix
from repro.testing import run_case as ref_run_case
from repro_torch.kernels.ops import choose_lex_engine
from repro_torch.pipeline.validate import host
from repro_torch.testing import (CONTRACTS, assert_conforms, available_modes,
                                 iter_matrix, provenance, run_case)
from repro_torch.testing.contracts import _LEX_MAX_VALUES
from repro_torch.testing.modes import TORCH_CPU

# the CPU's mode only: the card's two run in chip_smoke.py's phase 10
CPU = TORCH_CPU
MODES = (CPU,)
CELLS = iter_matrix(MODES)
BUILDS = sorted({(op, gen, dtype) for op, _, _, gen, dtype in CELLS})
RANDOM_CELLS = [(name, engine) for name, c in CONTRACTS.items()
                for engine in c.engines]


def _cell_id(cell):
    op, engine, mode, gen, dtype = cell
    return f"{op}-{engine}-{mode.name}-{gen}-{dtype}"


def _same_bits(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, \
        (got.dtype, want.dtype, got.shape, want.shape)
    assert got.tobytes() == want.tobytes()


def test_mode_axis_shape():
    """``torch-cpu`` first and everywhere; names unique; the card's two
    modes only where there is a card."""
    import torch
    modes = available_modes()
    names = [m.name for m in modes]
    assert names[0] == "torch-cpu" and len(set(names)) == len(names)
    assert ("cuda-kernel" in names) == torch.cuda.is_available()
    assert all(m.graph == (m.name == "cuda-graph") for m in modes)
    assert all(m.kernels == (m.device == "cuda") for m in modes)


def test_matrix_covers_every_engine_under_every_mode():
    seen = {(op, engine, mode.name) for op, engine, mode, _, _ in CELLS}
    for name, contract in CONTRACTS.items():
        for engine in contract.engines:
            for mode in MODES:
                assert (name, engine, mode.name) in seen


def test_registry_matches_reference():
    """The same ops, engines, generators and dtype rules as the
    reference's registry."""
    assert list(CONTRACTS) == list(REF_CONTRACTS)
    for name, c in CONTRACTS.items():
        r = REF_CONTRACTS[name]
        assert c.engines == r.engines, name
        assert c.generators == r.generators, name
        for gen in c.generators:
            assert c.dtypes_for(gen) == r.dtypes_for(gen), (name, gen)


def test_matrix_never_shrinks():
    """Per mode, no fewer cells than the reference's per mode (180 each of
    its two CPU modes), with its NaN and k-way floors."""
    ref = ref_available_modes()
    ref_cells = len(ref_iter_matrix(ref))
    per_mode = len(CELLS) // len(MODES)
    assert per_mode * len(MODES) == len(CELLS)
    assert per_mode >= ref_cells // len(ref) == 180
    assert sum(1 for c in CELLS if c[3] == "nan") >= 15 * len(MODES)
    assert sum(1 for c in CELLS if c[0] == "merge_runs") >= 15 * len(MODES)


def test_cases_are_deterministic_across_builds():
    for op in ("sort", "merge_sorted", "bucketize"):
        contract = CONTRACTS[op]
        gen = contract.generators[0]
        dtype = contract.dtypes_for(gen)[0]
        a, b = contract.build(gen, dtype), contract.build(gen, dtype)
        for x, y in zip(a.arrays, b.arrays):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("cell", CELLS, ids=[_cell_id(c) for c in CELLS])
def test_conformance(cell):
    op, engine, mode, gen, dtype = cell
    contract = CONTRACTS[op]
    reason = contract.supports(engine, mode, gen)
    if reason:
        pytest.skip(reason)
    case = contract.build(gen, dtype)
    run = run_case(contract, case, engine, mode)
    assert_conforms(contract, run.case, run.outputs)
    prov = run.provenance
    assert prov["mode"] == mode.name
    assert prov["backend"] == mode.device
    assert prov["kernels"] == ("cuda-c++ sm_90a" if mode.kernels
                               else "plain-torch")


def _flat(arrays):
    for a in arrays:
        if isinstance(a, (tuple, list)):
            yield from _flat(a)
        else:
            yield a


@pytest.mark.parametrize("build", BUILDS, ids=["-".join(b) for b in BUILDS])
def test_cases_match_reference(build):
    op, gen, dtype = build
    case = CONTRACTS[op].build(gen, dtype)
    ref = REF_CONTRACTS[op].build(gen, dtype)
    got, want = list(_flat(case.arrays)), list(_flat(ref.arrays))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _same_bits(g, w)
    assert sorted(case.meta) == sorted(ref.meta)
    for k in case.meta:
        if isinstance(ref.meta[k], np.ndarray):
            _same_bits(case.meta[k], ref.meta[k])
        else:
            assert case.meta[k] == ref.meta[k]


@pytest.mark.parametrize("build", BUILDS, ids=["-".join(b) for b in BUILDS])
def test_replayed_case_has_its_case_shapes(build):
    """A graph mode captures on a case and replays on ``build(gen, dtype,
    "replay")``: the same arrays' shapes and dtypes, other draws (the
    ``random`` cases at least differ), and ``run_case`` holds the replay to
    its own oracle; an eager mode answers the case itself."""
    op, gen, dtype = build
    contract = CONTRACTS[op]
    case, replay = contract.build(gen, dtype), contract.build(gen, dtype,
                                                              "replay")
    got, want = list(_flat(replay.arrays)), list(_flat(case.arrays))
    assert [(a.shape, a.dtype) for a in got] == \
        [(a.shape, a.dtype) for a in want]
    assert (replay.op, replay.gen, replay.dtype) == (op, gen, dtype)
    if gen == "random":
        assert any(not np.array_equal(g, w) for g, w in zip(got, want))
    assert run_case(contract, case, contract.engines[0], CPU).case is case


@pytest.mark.parametrize("build", BUILDS, ids=["-".join(b) for b in BUILDS])
def test_oracles_match_reference(build):
    op, gen, dtype = build
    case = CONTRACTS[op].build(gen, dtype)
    got = CONTRACTS[op].oracle(case)
    want = REF_CONTRACTS[op].oracle(REF_CONTRACTS[op].build(gen, dtype))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _same_bits(host(g), np.asarray(w))


@pytest.mark.parametrize("op,engine", RANDOM_CELLS,
                         ids=[f"{o}-{e}" for o, e in RANDOM_CELLS])
def test_random_case_matches_reference_op(op, engine):
    """The ``random`` case of each ``(op, engine)``, its first dtype: the
    port's plain versions against the reference op in its eager
    interpreter mode, bit for bit."""
    contract = CONTRACTS[op]
    dtype = contract.dtypes_for("random")[0]
    ref_mode = next(m for m in ref_available_modes() if not m.jit)
    got = run_case(contract, contract.build("random", dtype), engine,
                   CPU).outputs
    ref_c = REF_CONTRACTS[op]
    want = ref_run_case(ref_c, ref_c.build("random", dtype), engine,
                        ref_mode).outputs
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _same_bits(host(g), np.asarray(w))


def test_packed_lex_routing_is_honored():
    """The sort_lex 'packed' cells genuinely run the packed rank-key path:
    the lane bounds (2 + 32 + 16 = 50 bits) fit the 64-bit budget with
    fewer packed lanes; the same tuple without bounds falls back to
    'lanes'."""
    import torch
    dtypes = [torch.uint32] * 3
    assert choose_lex_engine(dtypes, max_values=_LEX_MAX_VALUES,
                             engine="packed") == "packed"
    assert choose_lex_engine(dtypes, max_values=None,
                             engine="packed") == "lanes"


@pytest.mark.parametrize("engine", ["bitonic", "blocksort"])
def test_nan_padding_hazard(engine):
    """The padded engines keep every NaN: the canonical order bits place
    each NaN below the all-ones padding sentinel."""
    contract = CONTRACTS["sort"]
    case = contract.build("nan", "float32")
    outputs = contract.run(case, engine, CPU)
    assert_conforms(contract, case, outputs)


def test_provenance_names_the_mode():
    p = provenance(CPU)
    assert p["mode"] == "torch-cpu" and p["graph"] is False
    assert p["kernels"] == "plain-torch"
