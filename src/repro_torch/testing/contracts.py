"""Op-contract registry: every public engine of ``kernels.ops`` bound to a
NumPy oracle, the canonical adversarial generator set, and the
execution-mode axis — the counterpart of ``repro.testing.contracts``.

One :class:`OpContract` per front-end op —
``sort / sort_kv / sort_lex / segmented_sort / merge_sorted /
merge_sorted_lex / merge_runs / bucketize / distribute`` — declaring, as
the reference does:

  * ``engines`` — every engine the op routes between (the comparator
    algorithms of the sorts — B1, B2, blocksort's B2 and B4 —, the merge
    engines — B5's kernel, B6's k-way kernel —, the capacity tiers of
    bucketize — B3 —); the matrix runs all of them;
  * ``generators`` x ``dtypes`` — which adversarial cases apply
    (``testing.generators``, the reference's copy), with the reference's
    per-generator dtype restriction;
  * ``build`` / ``oracle`` / ``check`` — deterministic case construction
    (CRC-seeded, stable across processes, and the same arrays as the
    reference's for the same ``(op, gen, dtype)``), the NumPy reference,
    and the conformance predicate: bit-identical by default; for the NaN
    cases the total-order contract — bit-level multiset conserved AND
    non-decreasing under the canonical order bits (checked through
    ``pipeline.validate.check_lanes_sorted``, the pipeline's own gate);
    capacity-parametric for bucketize;
  * ``run`` — executes the op under an :class:`~.modes.ExecutionMode`: the
    case's arrays as tensors on the mode's device, the op called eagerly,
    or captured once into a CUDA graph and the graph replayed on a second
    case.

``iter_matrix()`` expands the registry into (op, engine, mode, generator,
dtype) points; ``run_case`` returns the outputs with per-run provenance.

Mode support is explicit, not silent: a combination an engine cannot
honour is reported by ``supports()`` with a reason and surfaces as a skip,
never as a quietly-identical re-run. No engine of the port needs one:
every op call captures into a CUDA graph (none reads a device value back
inside it), and bucketize's autotune retry, host-synced by design, is
eager-only as in the reference — its ``cuda-graph`` program is the
traceable tier, distribute and one static-capacity scatter. A graph is
captured on the case's inputs and replayed on a second case of the same
shapes (``build(gen, dtype, "replay")``, another seed), copied into those
inputs first; :func:`run_case` holds the replay to that case's oracle, so
a plan, a value or a pointer that the capture took from the first case's
data shows. The k-way kernel's plan upload (``kway_kernel._device_plan``)
reads a pinned host buffer at every replay; torch's caching host
allocator (2.11 and 2.13) never recycles a pinned block that a capture
used, so the buffer outlives the call.
"""

from __future__ import annotations

import functools
import zlib
from dataclasses import dataclass, field
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..core.packing import byte_length, pack_words
from ..kernels import ops
from ..pipeline.merge import merge_runs as _pipeline_merge_runs
from ..pipeline.validate import (ValidationError, check_lanes_sorted, host,
                                 order_bits_view)
from .generators import (applicable, check_mode, default_n, fill_elements,
                         kway_run_sizes, make_words, sorted_run_sizes)
from .modes import ExecutionMode, provenance

__all__ = ["Case", "OpContract", "ConformanceRun", "CONTRACTS",
           "iter_matrix", "run_case", "assert_conforms"]

# forced blocksort block so sub-block inputs still exercise the engine and
# tile_boundary (n=129) genuinely spans two blocks
_BLOCK = 128
_WORD_WIDTH = 8          # bytes -> 2 uint32 lanes, num_buckets = 9
_SEG_SHAPE = (6, 32, 2)  # (buckets, capacity, lanes) of the segmented case


def _seed(*parts) -> int:
    # stable across processes (hash() is PYTHONHASHSEED-randomized)
    return zlib.crc32("-".join(map(str, parts)).encode())


@dataclass(frozen=True)
class Case:
    """One conformance input: ``arrays`` feed the op, ``meta`` carries
    host-side context the oracle needs (word lengths, counts, capacity)."""

    op: str
    gen: str
    dtype: str
    arrays: tuple
    meta: dict = field(default_factory=dict)

    @property
    def check(self) -> str:
        return check_mode(self.gen)


class ConformanceRun(NamedTuple):
    """Outputs of one op execution, the provenance it ran under, and the
    case whose oracle they answer (in a graph mode the replayed one)."""

    outputs: tuple
    provenance: dict
    case: Case


@dataclass(frozen=True)
class OpContract:
    name: str
    engines: tuple
    generators: tuple
    dtypes_for: Callable[[str], tuple]
    # (gen, dtype, *salt): a salt draws another case of the same shapes
    build: Callable[..., Case]
    # (case, engine, mode, replay): ``replay`` the case a graph replays
    run: Callable[..., tuple]
    oracle: Callable[[Case], tuple]
    # returns a skip reason, or None when the combination is runnable
    supports: Callable[[str, ExecutionMode, str], Optional[str]] = \
        lambda engine, mode, gen: None
    # override for ops whose conformance is not plain output==oracle
    check: Optional[Callable[[Case, tuple], None]] = None


# --- shared helpers ----------------------------------------------------------

def _tensor(a: np.ndarray, mode: ExecutionMode) -> torch.Tensor:
    """A case's array as a tensor on the mode's device, bits unchanged."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(mode.device)


def _inputs(case: Case, mode: ExecutionMode) -> tuple:
    """A case's arrays, nested runs and lanes flattened in order, as
    tensors on the mode's device."""
    def flat(x):
        if isinstance(x, (tuple, list)):
            for y in x:
                yield from flat(y)
        else:
            yield _tensor(x, mode)
    return tuple(flat(case.arrays))


def _call(mode: ExecutionMode, fn, case: Case,
          replay: Optional[Case] = None) -> tuple:
    """``fn`` (tensors in, a tuple of tensors out) on ``case``'s inputs
    (:func:`_inputs`) under ``mode``: eagerly, or — ``mode.graph`` — run
    once to warm up (builds the kernels, plans nothing lazily inside the
    capture), captured into a CUDA graph on those inputs, ``replay``'s
    arrays (the same shapes) copied into them, and the graph replayed; the
    outputs are the replay's, ``replay``'s answer."""
    args = _inputs(case, mode)
    if not mode.graph:
        return tuple(fn(*args))
    if replay is None:
        raise ValueError("a graph mode replays a second case")
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn(*args)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = tuple(fn(*args))
    for a, b in zip(args, _inputs(replay, mode), strict=True):
        a.copy_(b)
    graph.replay()
    torch.cuda.synchronize()
    return tuple(o.clone() for o in outs)


def _np(outs):
    return tuple(host(o) for o in outs)


def _bits(a: np.ndarray) -> np.ndarray:
    """Bit-pattern view for order-insensitive multiset compares (NaN-safe)."""
    return a.view({4: np.uint32, 8: np.uint64, 2: np.uint16, 1: np.uint8}
                  [a.dtype.itemsize])


def _assert_permutation(got, want):
    """Outputs are a bit-level row-multiset permutation of the inputs
    (lanes compared as parallel tuples) — NaN payload bits and ``-0.0``
    signs must survive exactly."""
    g = np.stack([_bits(np.ascontiguousarray(a)) for a in got])
    w = np.stack([_bits(np.ascontiguousarray(a)) for a in want])
    if g.shape != w.shape:
        raise AssertionError(f"shape changed: {g.shape} != {w.shape}")
    if g.size:
        g = g[:, np.lexsort(g[::-1])]
        w = w[:, np.lexsort(w[::-1])]
    np.testing.assert_array_equal(g, w)


def _assert_total_order(got, want):
    """The total-order NaN contract: outputs are a bit-level row-multiset
    permutation of the oracle reference AND lex non-decreasing under the
    canonical order bits (distinct NaN payloads tie, so only the multiset
    pins their bits). Sortedness runs through
    ``pipeline.validate.check_lanes_sorted`` — the production gate and the
    conformance matrix share one definition of "sorted"."""
    _assert_permutation(got, want)
    try:
        check_lanes_sorted(list(got), what="conformance output")
    except ValidationError as e:
        raise AssertionError(str(e)) from None


def assert_conforms(contract: OpContract, case: Case, outputs: tuple):
    """The conformance predicate: contract-custom check, total-order (NaN
    cases: multiset + canonical-order sortedness), or exact equality
    against the NumPy oracle."""
    if contract.check is not None:
        contract.check(case, outputs)
        return
    got = _np(outputs)
    want = _np(contract.oracle(case))
    assert len(got) == len(want)
    if case.check == "total_order":
        _assert_total_order(got, want)
        return
    for g, w in zip(got, want):
        assert g.dtype == w.dtype, f"dtype changed: {g.dtype} != {w.dtype}"
        np.testing.assert_array_equal(g, w)


def run_case(contract: OpContract, case: Case, engine: str,
             mode: ExecutionMode) -> ConformanceRun:
    """Execute one (case, engine, mode) cell and stamp its provenance; a
    graph mode replays its capture on a second case of the same shapes,
    whose oracle the outputs then answer."""
    if not mode.graph:
        return ConformanceRun(contract.run(case, engine, mode),
                              provenance(mode), case)
    replay = contract.build(case.gen, case.dtype, "replay")
    return ConformanceRun(contract.run(case, engine, mode, replay),
                          provenance(mode), replay)


# --- sort / sort_kv ----------------------------------------------------------

_SORT_ENGINES = ("oets", "bitonic", "blocksort")


def _sort_dtypes(gen: str) -> tuple:
    return {"random": ("int32", "float32"),
            "dup_heavy": ("int32", "float32"),
            "sentinel": ("int32", "uint32", "float32"),
            "nan": ("float32",)}.get(gen, ("int32",))


def _block(engine: str):
    return _BLOCK if engine == "blocksort" else None


def _build_sort(gen: str, dtype: str, *salt) -> Case:
    rng = np.random.default_rng(_seed("sort", gen, dtype, *salt))
    x = fill_elements(gen, rng, default_n(gen), dtype)
    return Case("sort", gen, dtype, (x,))


def _run_sort(case: Case, engine: str, mode: ExecutionMode,
              replay=None) -> tuple:
    return _call(mode, lambda x: (ops.sort(x, algorithm=engine,
                                           block_size=_block(engine)),),
                 case, replay)


def _oracle_sort(case: Case) -> tuple:
    return (np.sort(case.arrays[0]),) if case.check == "exact" \
        else (case.arrays[0],)


def _build_sort_kv(gen: str, dtype: str, *salt) -> Case:
    rng = np.random.default_rng(_seed("sort_kv", gen, dtype, *salt))
    n = default_n(gen)
    k = fill_elements(gen, rng, n, dtype)
    v = rng.permutation(n).astype(np.int32)
    return Case("sort_kv", gen, dtype, (k, v))


def _run_sort_kv(case: Case, engine: str, mode: ExecutionMode,
                 replay=None) -> tuple:
    return _call(mode, lambda k, v: ops.sort_kv(k, v, algorithm=engine,
                                                block_size=_block(engine)),
                 case, replay)


def _oracle_sort_kv(case: Case) -> tuple:
    k, v = case.arrays
    if case.check != "exact":
        return k, v
    order = np.lexsort((v, k))  # vals are the engines' final tie-break lane
    return k[order], v[order]


# --- sort_lex ----------------------------------------------------------------

# 3-lane tuple with per-lane bounds totalling 2+32+16 = 50 bits: inside the
# 64-bit rank-key budget with fewer packed (2) than original (3) lanes, so
# engine='packed' is genuinely honored (a full-width 3-lane uint32 tuple
# would overflow the budget and silently fall back to 'lanes'). Lane 1
# stays full-width so the sentinel generator still collides with
# 0xFFFFFFFF inside the packed path.
_LEX_MAX_VALUES = (3, None, 0xFFFF)


def _build_sort_lex(gen: str, dtype: str, *salt) -> Case:
    rng = np.random.default_rng(_seed("sort_lex", gen, dtype, *salt))
    n = default_n(gen)
    # tiny lane-0 alphabet so the deeper lanes actually decide the order
    lanes = (fill_elements("dup_heavy", rng, n, dtype),
             fill_elements(gen, rng, n, dtype),
             fill_elements(gen, rng, n, dtype) % np.uint32(0x10000))
    return Case("sort_lex", gen, dtype, tuple(lanes))


def _run_sort_lex(case: Case, engine: str, mode: ExecutionMode,
                  replay=None) -> tuple:
    return _call(mode, lambda *lanes: ops.sort_lex(
        list(lanes), engine=engine, max_values=_LEX_MAX_VALUES),
        case, replay)


def _lexsort_all(lanes):
    # lexsort over the canonical order-bit views (identity for integer
    # lanes), so float lanes sort NaN-correctly — np.lexsort on raw floats
    # would scatter NaN rows arbitrarily
    order = np.lexsort(tuple(reversed([order_bits_view(np.asarray(l))
                                       for l in lanes])))
    return tuple(np.asarray(l)[order] for l in lanes)


def _oracle_sort_lex(case: Case) -> tuple:
    return _lexsort_all(case.arrays)


# --- segmented_sort ----------------------------------------------------------

def _build_segmented(gen: str, dtype: str, *salt) -> Case:
    rng = np.random.default_rng(_seed("segmented", gen, dtype, *salt))
    nb, cap, lanes = _SEG_SHAPE
    if gen == "empty":
        nb, cap = 0, 0
    elif gen == "singleton":
        nb, cap = 1, 1
    elif gen == "tile_boundary":
        nb, cap = 2, 129
    keys = fill_elements("random" if gen in ("empty", "singleton",
                                             "tile_boundary") else gen,
                         rng, nb * cap * lanes, dtype).reshape(nb, cap, lanes)
    if gen == "skewed":
        counts = np.resize([0, cap, 1, cap - 1], nb).astype(np.int32)
    else:
        counts = rng.integers(0, cap + 1, nb).astype(np.int32)
    return Case("segmented_sort", gen, dtype, (keys, counts))


def _run_segmented(case: Case, engine: str, mode: ExecutionMode,
                   replay=None) -> tuple:
    del engine  # single fused engine; width routes via choose_plan inside
    return _call(mode, lambda k, c: (ops.segmented_sort(k, c),), case,
                 replay)


def _sentinel(dtype) -> np.ndarray:
    """The padding sentinel of a numpy integer dtype (its maximum)."""
    return np.iinfo(dtype).max


def _oracle_segmented(case: Case) -> tuple:
    keys, counts = case.arrays
    out = np.empty_like(keys)
    sent = _sentinel(keys.dtype)
    for b in range(keys.shape[0]):
        rows = keys[b].copy()
        rows[counts[b]:] = sent  # the op masks slots >= count to sentinel
        order = np.lexsort(tuple(reversed([rows[:, l]
                                           for l in range(rows.shape[1])])))
        out[b] = rows[order]
    return (out,)


# --- merge_sorted / merge_sorted_lex ----------------------------------------

_MERGE_ENGINES = ("packed", "kernel", "lanes", "kway")


def _merge_dtypes(gen: str) -> tuple:
    return {"random": ("int32", "float32"),
            "sentinel": ("int32", "uint32"),
            "nan": ("float32",)}.get(gen, ("int32",))


def _ob_sort(x: np.ndarray) -> np.ndarray:
    """Stable sort under the canonical order bits — the only host-side sort
    that builds a *valid* merge input run out of NaN data (np.sort leaves
    the NaN tail in arbitrary payload order, which breaks the order-bit
    sortedness precondition when the all-ones sentinel pattern is among
    the payloads)."""
    return x[np.argsort(order_bits_view(x), kind="stable")]


def _build_merge(gen: str, dtype: str, *salt) -> Case:
    rng = np.random.default_rng(_seed("merge", gen, dtype, *salt))
    na, nb = sorted_run_sizes(gen)
    a = _ob_sort(fill_elements(gen, rng, na, dtype))
    b = _ob_sort(fill_elements(gen, rng, nb, dtype))
    return Case("merge_sorted", gen, dtype, (a, b))


def _run_merge(case: Case, engine: str, mode: ExecutionMode,
               replay=None) -> tuple:
    return _call(mode, lambda a, b: (ops.merge_sorted(a, b, engine=engine),),
                 case, replay)


def _oracle_merge(case: Case) -> tuple:
    # _ob_sort, not np.sort: numpy's vectorised float sort canonicalises
    # NaN payloads and -0.0 signs (observed on numpy 2.0), which would
    # corrupt the very bit multiset the NaN contract checks
    return (_ob_sort(np.concatenate(case.arrays)),)


def _build_merge_lex(gen: str, dtype: str, *salt) -> Case:
    rng = np.random.default_rng(_seed("merge_lex", gen, dtype, *salt))
    na, nb = sorted_run_sizes(gen)

    def run(n):
        lanes = [fill_elements("dup_heavy", rng, n, dtype),
                 fill_elements(gen, rng, n, dtype),
                 np.arange(n, dtype=np.int32)]  # payload = final tie-break
        return _lexsort_all(lanes)  # runs must be sorted by the full tuple

    return Case("merge_sorted_lex", gen, dtype, (run(na), run(nb)))


def _run_merge_lex(case: Case, engine: str, mode: ExecutionMode,
                   replay=None) -> tuple:
    n_arr = len(case.arrays[0])
    return _call(mode, lambda *arrs: tuple(ops.merge_sorted_lex(
        arrs[:n_arr], arrs[n_arr:], engine=engine)), case, replay)


def _oracle_merge_lex(case: Case) -> tuple:
    a_lanes, b_lanes = case.arrays
    return _lexsort_all([np.concatenate([a, b])
                         for a, b in zip(a_lanes, b_lanes)])


# --- merge_runs (one-pass k-way vs the tournament) ---------------------------

# 'kway' = the one-pass front end as 'auto' routes it (the k-way kernel, B6,
# on a card past two output blocks, the 'take' tier otherwise);
# 'kway_kernel' forces B6 (block 128 so the case genuinely spans blocks);
# 'tournament' = the pairwise tree kept as the differential oracle.
_KWAY_ENGINES = ("kway", "kway_kernel", "tournament")


def _build_merge_runs(gen: str, dtype: str, *salt) -> Case:
    rng = np.random.default_rng(_seed("merge_runs", gen, dtype, *salt))
    data_gen = "random" if gen == "empty_run" else gen

    def run(n):
        lanes = [fill_elements("dup_heavy", rng, n, dtype),
                 fill_elements(data_gen, rng, n, dtype),
                 np.arange(n, dtype=np.int32)]  # payload = final tie-break
        return _lexsort_all(lanes)  # runs must be sorted by the full tuple

    return Case("merge_runs", gen, dtype,
                tuple(run(n) for n in kway_run_sizes(gen)))


def _run_merge_runs(case: Case, engine: str, mode: ExecutionMode,
                    replay=None) -> tuple:
    n_arr = len(case.arrays[0])
    k = len(case.arrays)

    def call(*arrs):
        runs = [arrs[i * n_arr:(i + 1) * n_arr] for i in range(k)]
        return tuple(_pipeline_merge_runs(runs, engine=engine,
                                          block_size=_BLOCK))

    return _call(mode, call, case, replay)


def _oracle_merge_runs(case: Case) -> tuple:
    return _lexsort_all([np.concatenate([r[i] for r in case.arrays])
                         for i in range(len(case.arrays[0]))])


# --- distribute / bucketize --------------------------------------------------

def _build_words(op: str, gen: str, dtype: str, *salt) -> Case:
    rng = np.random.default_rng(_seed(op, gen, dtype, *salt))
    words = make_words(gen, rng, max_len=_WORD_WIDTH)
    keys = pack_words(words, width=_WORD_WIDTH)
    lengths = np.array([byte_length(w) for w in words], np.int32)
    num_buckets = 4 * keys.shape[1] + 1
    # the stable-rank oracle: arrival order within each length bucket
    rank = np.zeros(len(words), np.int32)
    seen: dict = {}
    for i, l in enumerate(lengths):
        rank[i] = seen.get(int(l), 0)
        seen[int(l)] = rank[i] + 1
    counts = np.bincount(lengths, minlength=num_buckets).astype(np.int32) \
        if len(words) else np.zeros(num_buckets, np.int32)
    return Case(op, gen, dtype, (keys,),
                meta={"lengths": lengths, "rank": rank, "counts": counts,
                      "num_buckets": num_buckets})


def _run_distribute(case: Case, engine: str, mode: ExecutionMode,
                    replay=None) -> tuple:
    del engine
    return _call(mode, ops.distribute, case, replay)


def _oracle_distribute(case: Case) -> tuple:
    return (case.meta["lengths"], case.meta["rank"], case.meta["counts"])


def _expected_buckets(case: Case, capacity: int) -> np.ndarray:
    """The bucket tensor at an arbitrary capacity (the op autotunes its
    own): word i lands at [dest, rank] when rank < capacity, sentinel
    elsewhere — the documented clip semantics of ``scatter_to_buckets``."""
    keys = case.arrays[0]
    nb = case.meta["num_buckets"]
    out = np.full((nb, capacity, keys.shape[1]), np.uint32(0xFFFFFFFF),
                  np.uint32)
    for i in range(keys.shape[0]):
        r = case.meta["rank"][i]
        if r < capacity:
            out[case.meta["lengths"][i], r] = keys[i]
    return out


def _run_bucketize(case: Case, engine: str, mode: ExecutionMode,
                   replay=None) -> tuple:
    nb = case.meta["num_buckets"]
    counts = case.meta["counts"]
    cap = int(counts.max()) if counts.size and counts.max() else 0
    n = case.arrays[0].shape[0]
    if not mode.graph:
        keys, = _inputs(case, mode)
        res = ops.bucketize(keys,
                            capacity=None if engine == "autotune" else cap)
        assert res.dropped == 0
        return res.buckets, res.counts
    # graph mode: the traceable tier — distribute + one static-capacity
    # scatter in a single captured call. autotune's graph tier is the
    # optimistic first-shot capacity; its host-synced exact-count retry is
    # eager-only by design (the reference's rule under jit). The capacity
    # is the captured case's; the replayed case's words past it are
    # dropped, as the clip semantics the check holds them to say.
    if engine == "autotune":
        cap = ops._optimistic_capacity(n, nb) if n else 0

    def program(k):
        dest, rank, cnt = ops.distribute(k)
        return ops.scatter_to_buckets(k, dest, rank, num_buckets=nb,
                                      capacity=cap), cnt

    return _call(mode, program, case, replay)


def _check_bucketize(case: Case, outputs: tuple):
    buckets, counts = _np(outputs[:2])
    capacity = buckets.shape[1]
    np.testing.assert_array_equal(buckets,
                                  _expected_buckets(case, capacity))
    np.testing.assert_array_equal(counts, case.meta["counts"])


# --- registry ----------------------------------------------------------------

def _const_dtypes(*dts):
    return lambda gen: dts


_NO_NAN = tuple(g for g in ("random", "dup_heavy", "sentinel", "skewed",
                            "empty", "singleton", "tile_boundary"))
_WORD_GENS = _NO_NAN  # word cases: nan is meaningless for packed bytes

CONTRACTS: dict = {}


def _register(c: OpContract):
    CONTRACTS[c.name] = c


_register(OpContract(
    name="sort", engines=_SORT_ENGINES,
    generators=("random", "dup_heavy", "sentinel", "nan", "skewed",
                "empty", "singleton", "tile_boundary"),
    dtypes_for=_sort_dtypes, build=_build_sort, run=_run_sort,
    oracle=_oracle_sort))

_register(OpContract(
    name="sort_kv", engines=_SORT_ENGINES,
    generators=("random", "dup_heavy", "sentinel", "nan", "singleton"),
    dtypes_for=lambda gen: ("float32",) if gen == "nan" else ("int32",),
    build=_build_sort_kv, run=_run_sort_kv, oracle=_oracle_sort_kv))

_register(OpContract(
    name="sort_lex", engines=("lanes", "packed"),
    generators=_NO_NAN,
    dtypes_for=_const_dtypes("uint32"),
    build=_build_sort_lex, run=_run_sort_lex, oracle=_oracle_sort_lex))

_register(OpContract(
    name="segmented_sort", engines=("fused",),
    generators=_NO_NAN,
    dtypes_for=_const_dtypes("uint32"),
    build=_build_segmented, run=_run_segmented, oracle=_oracle_segmented))

_register(OpContract(
    name="merge_sorted", engines=_MERGE_ENGINES,
    generators=("random", "dup_heavy", "sentinel", "nan", "skewed",
                "empty", "singleton", "tile_boundary"),
    dtypes_for=_merge_dtypes, build=_build_merge, run=_run_merge,
    oracle=_oracle_merge))

_register(OpContract(
    name="merge_sorted_lex", engines=_MERGE_ENGINES,
    generators=("random", "dup_heavy", "sentinel", "nan", "skewed",
                "empty", "singleton", "tile_boundary"),
    dtypes_for=lambda gen: ("float32",) if gen == "nan" else ("uint32",),
    build=_build_merge_lex, run=_run_merge_lex, oracle=_oracle_merge_lex))

_register(OpContract(
    name="merge_runs", engines=_KWAY_ENGINES,
    generators=("random", "dup_heavy", "sentinel", "nan", "empty_run"),
    dtypes_for=lambda gen: ("float32",) if gen == "nan" else ("uint32",),
    build=_build_merge_runs, run=_run_merge_runs,
    oracle=_oracle_merge_runs))

_register(OpContract(
    name="distribute", engines=("kernel",),
    generators=_WORD_GENS,
    dtypes_for=_const_dtypes("uint32"),
    build=functools.partial(_build_words, "distribute"),
    run=_run_distribute, oracle=_oracle_distribute))

_register(OpContract(
    name="bucketize", engines=("autotune", "explicit"),
    generators=_WORD_GENS,
    dtypes_for=_const_dtypes("uint32"),
    build=functools.partial(_build_words, "bucketize"),
    run=_run_bucketize, oracle=lambda case: (),
    check=_check_bucketize))


def iter_matrix(modes) -> list:
    """Expand the registry into (op, engine, mode, generator, dtype) cells.
    Applies the per-generator dtype restriction and dtype applicability;
    per-(engine, mode) support is resolved at run time (skip-with-reason,
    never silent)."""
    cells = []
    for contract in CONTRACTS.values():
        for engine in contract.engines:
            for mode in modes:
                for gen in contract.generators:
                    for dtype in contract.dtypes_for(gen):
                        if applicable(gen, dtype):
                            cells.append((contract.name, engine, mode,
                                          gen, dtype))
    return cells
