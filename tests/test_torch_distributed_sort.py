"""The port's mesh engines (``repro_torch.core.distributed``) against the
reference's (``repro.core.distributed``), following
``tests/test_distributed_sort.py``'s cases.

The reference runs once in a subprocess on 8 fake XLA devices and writes
every case's output; the port runs once as 8 gloo ranks on the CPU
(``tests/_torch_mesh.py``), each rank calling the host-facing
``distributed_sort_lex`` collectively and the SPMD ``sample_sort`` /
``sample_sort_lex`` on its own shard. Every case is then held to the
reference's output: bit for bit where every lane is an integer lane; where
a lane is float32, to the canonical contract — the same order keys
(``-0.0 == +0.0``, NaNs above ``+inf``) and an output that is a bit-level
permutation of the input (the reference's CPU default sorts with XLA,
whose tie order among order-equal floats is its own). Every rank must
return the same tuple. Host-side pieces (the engine cost model, the merge
strategies) run in-process.
"""

import hashlib
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest

from _torch_mesh import (engine_cases, has_float, launch_ranks,
                         odd_even_input, protocol_cases, run_reference)
from repro.core.distributed import _MERGES_LEX as REF_MERGES
from repro.core.distributed import choose_engine as ref_choose_engine
from repro.core.distributed import local_merge as ref_local_merge
from repro.pipeline.validate import order_bits_view
from repro_torch.core.distributed import (_MERGES_LEX, choose_engine,
                                          local_merge)
from repro_torch.interop import to_device, to_numpy

WORLD = 8

_CASE_NAMES = [c[0] for c in engine_cases()]
_PROTOCOL_NAMES = [c[0] for c in protocol_cases()]

# --------------------------------------------------------------------------
# the two runs, once each per file
# --------------------------------------------------------------------------

_REF_SCRIPT = r"""
import sys, numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from _torch_mesh import engine_cases, odd_even_input, protocol_cases
from repro.core.distributed import (distributed_sort_lex,
                                    odd_even_block_sort, sample_sort,
                                    sample_sort_lex)
from repro.parallel.compat import AxisType, make_mesh, shard_map
from repro.runtime import CapacityOverflow

assert len(jax.devices()) == 8
mesh = make_mesh((8,), ("d",), axis_types=(AxisType.Auto,))
out = {}
for name, lanes, vals, kw in engine_cases():
    try:
        res = distributed_sort_lex(
            [jnp.asarray(a) for a in lanes], mesh, axis="d",
            vals=None if vals is None else jnp.asarray(vals), **kw)
    except CapacityOverflow as e:
        out[name + "/raise"] = np.asarray([e.capacity, e.required])
        continue
    if vals is not None:
        res = (*res[0], res[1])
    for i, o in enumerate(res):
        out[f"{name}/{i}"] = np.asarray(o)

for name, x, cap in protocol_cases():
    def body(blk):
        res = sample_sort_lex([blk], axis_name="d", capacity=cap)
        return res.lanes[0], res.count[None], res.overflow[None]
    fn = jax.jit(shard_map(body, mesh=mesh, in_specs=P("d"),
                           out_specs=(P("d"), P("d"), P("d"))))
    vals, counts, ovf = fn(jnp.asarray(x))
    out[name + "/lanes"] = np.asarray(vals).reshape(8, -1)
    out[name + "/count"] = np.asarray(counts)
    out[name + "/overflow"] = np.asarray(ovf)
    if cap is None:    # the key-only view gives the same values and counts
        def body1(blk):
            v, c = sample_sort(blk, axis_name="d")
            return v, c[None]
        fn1 = jax.jit(shard_map(body1, mesh=mesh, in_specs=P("d"),
                                out_specs=(P("d"), P("d"))))
        v, c = fn1(jnp.asarray(x))
        assert (np.asarray(v).reshape(8, -1).view(np.uint8)
                == out[name + "/lanes"].view(np.uint8)).all()
        assert (np.asarray(c) == out[name + "/count"]).all()

for merge in ("resort", "bitonic", "take"):
    fn = jax.jit(shard_map(
        lambda blk: odd_even_block_sort(blk, axis_name="d", merge=merge),
        mesh=mesh, in_specs=P("d"), out_specs=P("d")))
    out[f"spmd-odd_even-{merge}"] = np.asarray(
        fn(jnp.asarray(odd_even_input()))).reshape(8, -1)
np.savez(sys.argv[1], **out)
print("REF_OK", len(out))
"""

_RANK_SCRIPT = r"""
import hashlib
import numpy as np
from _torch_mesh import engine_cases, odd_even_input, protocol_cases
from repro_torch.core.distributed import (_chunk_devices, distributed_sort_lex,
                                          odd_even_block_sort, sample_sort,
                                          sample_sort_lex)
from repro_torch.interop import to_device, to_numpy
from repro_torch.parallel import axis_index, axis_size, make_mesh
from repro_torch.runtime import CapacityOverflow

mesh = make_mesh((world,), ("d",), "cpu")
group = mesh.get_group("d")
assert axis_size(group) == world and axis_index(group) == rank
assert _chunk_devices(mesh, "d", None) == [torch.device("cpu")] * world
out = {}

def keep(key, arr):
    # rank 0 keeps the arrays, the others a hash of their bytes
    arr = np.ascontiguousarray(arr)
    out[key] = arr if rank == 0 else np.frombuffer(
        hashlib.sha256(arr.tobytes()).digest(), np.uint8)

for name, lanes, vals, kw in engine_cases():
    try:
        res = distributed_sort_lex(lanes, mesh, axis="d", vals=vals,
                                   device="cpu", **kw)
    except CapacityOverflow as e:
        out[name + "/raise"] = np.asarray([e.capacity, e.required])
        continue
    if vals is not None:
        res = (*res[0], res[1])
    for i, o in enumerate(res):
        keep(f"{name}/{i}", to_numpy(o))

for name, x, cap in protocol_cases():
    b = x.shape[0] // world
    blk = to_device(x[rank * b:(rank + 1) * b], "cpu")
    res = sample_sort_lex([blk], group, capacity=cap)
    out[name + "/lanes"] = to_numpy(res.lanes[0])
    out[name + "/count"] = np.asarray([int(res.count)])
    out[name + "/overflow"] = np.asarray([bool(res.overflow)])
    if cap is None:
        v, c = sample_sort(blk, group)
        assert (to_numpy(v).view(np.uint8)
                == out[name + "/lanes"].view(np.uint8)).all()
        assert int(c) == int(res.count)

x = odd_even_input()
b = x.shape[0] // world
for merge in ("resort", "bitonic", "take"):
    out[f"spmd-odd_even-{merge}"] = to_numpy(odd_even_block_sort(
        to_device(x[rank * b:(rank + 1) * b], "cpu"), group, merge=merge))
np.savez(f"{workdir}/port{rank}.npz", **out)
dist.destroy_process_group()
print("RANK_OK", rank)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both runs at once: the reference's subprocess on a thread while the
    port's ranks run."""
    workdir = tmp_path_factory.mktemp("mesh")
    with ThreadPoolExecutor(max_workers=1) as ex:
        ref_run = ex.submit(run_reference, _REF_SCRIPT,
                            [workdir / "ref.npz"], 400)
        launch_ranks(_RANK_SCRIPT, WORLD, workdir, timeout=300)
        assert "REF_OK" in ref_run.result()
    return (dict(np.load(workdir / "ref.npz")),
            [dict(np.load(workdir / f"port{r}.npz")) for r in range(WORLD)])


@pytest.fixture(scope="module")
def ref(runs):
    return runs[0]


@pytest.fixture(scope="module")
def port(runs):
    return runs[1]


# --------------------------------------------------------------------------
# host side
# --------------------------------------------------------------------------

def test_choose_engine_matches_reference_over_a_grid():
    for p in (1, 2, 3, 4, 8, 16):
        for b in (1, 64, 4096):
            for eng in ("auto", "odd_even", "sample"):
                assert choose_engine(p, b, eng) == ref_choose_engine(p, b,
                                                                     eng)
    for bad in ("quantum", "bitonic"):
        with pytest.raises(ValueError):
            choose_engine(8, 64, engine=bad)
        with pytest.raises(ValueError):
            ref_choose_engine(8, 64, engine=bad)


@pytest.mark.parametrize("strategy", ["resort", "bitonic", "take"])
@pytest.mark.parametrize("dtype", [np.int32, np.uint32])
def test_merge_strategies_duplicate_heavy(strategy, dtype):
    """Every merge strategy gives the reference's merge of two sorted
    duplicate-heavy blocks (rank collisions would double-write slots), as
    a 2-lane tuple and key-only."""
    rng = np.random.default_rng(1)
    a = [np.sort(rng.integers(0, 4, 128).astype(dtype)),
         rng.integers(0, 9, 128).astype(np.int32)]
    b = [np.sort(rng.integers(0, 4, 128).astype(dtype)),
         rng.integers(0, 9, 128).astype(np.int32)]
    a = [x[np.lexsort((a[1], a[0]))] for x in a]
    b = [x[np.lexsort((b[1], b[0]))] for x in b]
    ref_sort = lambda ls: list(jax_sort(ls))   # noqa: E731
    want = REF_MERGES[strategy]([jnp.asarray(x) for x in a],
                                [jnp.asarray(x) for x in b], ref_sort)
    got = _MERGES_LEX[strategy]([to_device(x, "cpu") for x in a],
                                [to_device(x, "cpu") for x in b],
                                lambda ls: _port_sort(ls))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), to_numpy(g))
    want1 = ref_local_merge(jnp.asarray(a[0]), jnp.asarray(b[0]), strategy)
    got1 = local_merge(to_device(a[0], "cpu"), to_device(b[0], "cpu"),
                       strategy)
    np.testing.assert_array_equal(np.asarray(want1), to_numpy(got1))
    np.testing.assert_array_equal(
        to_numpy(got1), np.sort(np.concatenate([a[0], b[0]])))


def jax_sort(lanes):
    from jax import lax
    return lax.sort(list(lanes), num_keys=len(lanes))


def _port_sort(lanes):
    from repro_torch.core.distributed import _local_sort_fn
    return _local_sort_fn("auto")(lanes)


def test_local_sort_choices_are_the_full_tuple_sort():
    from repro_torch.core.distributed import _local_sort_fn
    rng = np.random.default_rng(2)
    lanes = [rng.integers(0, 3, 3000).astype(np.uint32),
             rng.integers(-5, 5, 3000).astype(np.int32),
             rng.integers(0, 1 << 32, 3000, dtype=np.uint64).astype(
                 np.uint32)]
    want = [np.asarray(x) for x in jax_sort([jnp.asarray(a) for a in lanes])]
    for choice in ("auto", "pallas", "xla"):
        got = _local_sort_fn(choice)([to_device(a, "cpu") for a in lanes])
        for w, g in zip(want, got):
            np.testing.assert_array_equal(w, to_numpy(g))
    with pytest.raises(ValueError, match="local_sort"):
        _local_sort_fn("quantum")


# --------------------------------------------------------------------------
# the 8-rank cases against the reference's 8 devices
# --------------------------------------------------------------------------

def _digest(a):
    return np.frombuffer(hashlib.sha256(
        np.ascontiguousarray(a).tobytes()).digest(), np.uint8)


def _assert_contract(got, want, inputs):
    """Float lanes: the same canonical order keys as the reference, and a
    bit-level permutation of the input rows."""
    for g, w in zip(got, want):
        np.testing.assert_array_equal(order_bits_view(g), order_bits_view(w))
    rows = lambda ls: sorted(zip(*[np.ascontiguousarray(x).view(  # noqa
        np.uint32).tolist() for x in ls]))
    if got[0].shape[0] == inputs[0].shape[0]:
        assert rows(got) == rows(inputs)


@pytest.mark.parametrize("name", _CASE_NAMES)
def test_engine_case_matches_reference(name, ref, port):
    case = next(c for c in engine_cases() if c[0] == name)
    _, lanes, vals, _kw = case
    if name + "/raise" in ref:
        np.testing.assert_array_equal(port[0][name + "/raise"],
                                      ref[name + "/raise"])
        for r in range(1, WORLD):      # every rank raised alike
            assert name + "/raise" in port[r]
        return
    n_out = len(lanes) + (vals is not None)
    want = [ref[f"{name}/{i}"] for i in range(n_out)]
    got = [port[0][f"{name}/{i}"] for i in range(n_out)]
    for w, g in zip(want, got):
        assert g.dtype == w.dtype and g.shape == w.shape
    if has_float(lanes, vals):
        _assert_contract(got, want,
                         list(lanes) + ([] if vals is None else [vals]))
    else:
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g, w)
    for r in range(1, WORLD):          # every rank returns the same tuple
        for i in range(n_out):
            np.testing.assert_array_equal(port[r][f"{name}/{i}"],
                                          _digest(got[i]))


def test_engine_cases_sort(ref):
    """The reference's outputs themselves are the sorted inputs (the
    oracle the cases stand on): ``np.sort`` for key-only integer cases,
    the retry policy lossless, clip short and sorted."""
    for name, lanes, vals, kw in engine_cases():
        if vals is None and len(lanes) == 1 and not has_float(lanes, None):
            if kw.get("on_overflow") == "clip":
                got = ref[name + "/0"]
                assert got.shape[0] < lanes[0].shape[0]
                assert (np.diff(got.astype(np.int64)) >= 0).all()
            elif kw.get("on_overflow") != "raise":
                np.testing.assert_array_equal(ref[name + "/0"],
                                              np.sort(lanes[0]))


@pytest.mark.parametrize("name", _PROTOCOL_NAMES)
def test_exchange_protocol_matches_reference(name, ref, port):
    """The SPMD sample engine on every rank's shard: the exact counts (real
    sentinel-valued elements counted, never inferred from values), each
    rank's lanes and its overflow flag — capacity 8 of B = 64 on all-equal
    keys must flag, the default capacity never."""
    want_lanes = ref[name + "/lanes"]
    for r in range(WORLD):
        np.testing.assert_array_equal(port[r][name + "/lanes"].view(np.uint8),
                                      want_lanes[r].view(np.uint8))
        assert int(port[r][name + "/count"][0]) == int(
            ref[name + "/count"][r])
        assert bool(port[r][name + "/overflow"][0]) == bool(
            ref[name + "/overflow"][r])
    counts = sum(int(port[r][name + "/count"][0]) for r in range(WORLD))
    overflow = any(bool(port[r][name + "/overflow"][0])
                   for r in range(WORLD))
    n = next(x for nm, x, _ in protocol_cases() if nm == name).shape[0]
    if name == "overflow":
        assert overflow and counts < n
    else:
        assert not overflow and counts == n


@pytest.mark.parametrize("merge", ["resort", "bitonic", "take"])
def test_odd_even_engine_shards_match_reference(merge, ref, port):
    """The SPMD odd-even engine, key-only, on every rank's own block: each
    rank's shard is the reference device's, and the shards in rank order
    are the sorted input."""
    key = f"spmd-odd_even-{merge}"
    for r in range(WORLD):
        np.testing.assert_array_equal(port[r][key], ref[key][r])
    np.testing.assert_array_equal(
        np.concatenate([port[r][key] for r in range(WORLD)]),
        np.sort(odd_even_input()))
