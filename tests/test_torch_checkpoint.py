"""The port's checkpoint manager (``repro_torch.checkpoint``), its elastic
supervisor and its straggler monitor, against the reference's
(``repro.checkpoint``, ``repro.runtime``): the cases of
``tests/test_checkpoint.py`` and the elastic half of
``tests/test_failure.py``, and snapshots crossing between the packages in
both directions — the same files, the same manifest, the same bits."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as ref_ckpt
from repro import runtime as ref_runtime
from repro_torch.checkpoint import (CheckpointManager, CorruptSnapshotError,
                                    latest_step, list_steps, read_manifest,
                                    restore, save, sweep_tmp)
import repro_torch.runtime as port_runtime
from repro_torch.interop import to_device, to_numpy
from repro_torch.pipeline import RunStore
from repro_torch.runtime import (DeviceFailure, ElasticSupervisor,
                                 FailureInjector, StragglerMonitor)


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "a": torch.from_numpy(rng.normal(size=(4, 3)).astype(np.float32)),
        "nested": {"b": torch.from_numpy(
            rng.integers(0, 10, (5,)).astype(np.int32))},
    }


def _np_trees():
    """Trees of numpy leaves both packages save: nested dicts, lists,
    tuples, uint32 with its top bit set, scalars and empty arrays."""
    rng = np.random.default_rng(7)
    u32 = rng.integers(0, 1 << 32, (6, 3), dtype=np.uint64).astype(np.uint32)
    u32[0, 0] = 0xFFFFFFFF
    return {
        "nested-dicts": {"z": {"y": np.arange(4, dtype=np.int32),
                               "x": u32},
                         "a": rng.normal(size=(2, 2)).astype(np.float32)},
        "lists-and-tuples": {"runs": [u32, (np.int32(5), u32[:, 0])],
                             "w": [np.zeros((0, 2), np.uint32)]},
        "top-level-list": [np.float32(1.5), {"k": u32[1]}, u32[:2]],
    }


def _flat(tree, out=None):
    out = [] if out is None else out
    if isinstance(tree, dict):
        for k in sorted(tree):
            _flat(tree[k], out)
    elif isinstance(tree, (list, tuple)):
        for sub in tree:
            _flat(sub, out)
    else:
        out.append(tree)
    return out


def _to_torch(tree):
    """The tree with every array leaf a CPU tensor (numbers stay)."""
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_torch(v) for v in tree)
    return to_device(tree, "cpu") if isinstance(tree, np.ndarray) else tree


def _bits(x) -> np.ndarray:
    a = np.ascontiguousarray(
        to_numpy(x) if isinstance(x, torch.Tensor) else np.asarray(x))
    return a.view(np.uint8) if a.ndim else a.reshape(1).view(np.uint8)


def _same(got, want):
    g, w = _flat(got), _flat(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        a_np = to_numpy(a) if isinstance(a, torch.Tensor) else np.asarray(a)
        b_np = to_numpy(b) if isinstance(b, torch.Tensor) else np.asarray(b)
        assert a_np.dtype == b_np.dtype and a_np.shape == b_np.shape
        np.testing.assert_array_equal(_bits(a_np), _bits(b_np))


# ---------------------------------------------------------------------------
# the cases of tests/test_checkpoint.py
# ---------------------------------------------------------------------------

def test_save_restore_roundtrip(tmp_path):
    t = _tree()
    save(str(tmp_path), 7, t)
    assert latest_step(str(tmp_path)) == 7
    out = restore(str(tmp_path), 7, t, device="cpu")
    assert set(out) == {"a", "nested"}
    assert all(isinstance(x, torch.Tensor) for x in _flat(out))
    _same(out, t)


def test_atomicity_no_tmp_left(tmp_path):
    save(str(tmp_path), 1, _tree())
    assert not any(d.startswith(".tmp") for d in os.listdir(tmp_path))


def test_keep_n_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    for s in (1, 2, 3, 4):
        mgr.save(s, _tree(s))
    assert list_steps(str(tmp_path)) == [3, 4]


def test_async_save_then_restore(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3, async_save=True)
    t = _tree(5)
    mgr.save(11, t)
    t["a"].zero_()            # the host copy was taken before save returned
    step, out = mgr.restore_latest(t, device="cpu")
    assert step == 11
    _same(out, _tree(5))
    assert CheckpointManager(str(tmp_path / "empty")).restore_latest(
        t, device="cpu") == (None, None)


def test_restore_shape_mismatch_raises(tmp_path):
    save(str(tmp_path), 1, _tree())
    bad = {"a": torch.zeros((2, 2)),
           "nested": {"b": torch.zeros(5, dtype=torch.int32)}}
    with pytest.raises(ValueError):
        restore(str(tmp_path), 1, bad, device="cpu")
    with pytest.raises(KeyError, match="missing leaf"):
        restore(str(tmp_path), 1, {"c": torch.zeros(1)}, device="cpu")


def test_restore_defaults_to_the_card(tmp_path):
    save(str(tmp_path), 1, _tree())
    if torch.cuda.is_available():
        out = restore(str(tmp_path), 1, _tree())
        assert out["a"].device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        restore(str(tmp_path), 1, _tree())


@pytest.mark.parametrize("leaf", ["text", object(), {1, 2}])
def test_leaves_other_than_arrays_and_numbers_raise(tmp_path, leaf):
    with pytest.raises(TypeError, match="leaf"):
        save(str(tmp_path), 1, {"a": np.zeros(2), "b": [leaf]})
    assert list_steps(str(tmp_path)) == []


def test_truncated_npy_raises_typed_error_naming_path(tmp_path):
    t = _tree()
    save(str(tmp_path), 3, t)
    victim = os.path.join(str(tmp_path), "step_3", "a.npy")
    with open(victim, "r+b") as f:
        f.truncate(os.path.getsize(victim) // 2)
    with pytest.raises(CorruptSnapshotError) as ei:
        restore(str(tmp_path), 3, t, device="cpu")
    assert victim in str(ei.value)
    assert ei.value.path == victim


def test_zero_length_npy_raises_typed_error(tmp_path):
    t = _tree()
    save(str(tmp_path), 1, t)
    victim = os.path.join(str(tmp_path), "step_1", "a.npy")
    with open(victim, "wb"):
        pass
    with pytest.raises(CorruptSnapshotError, match="zero-length"):
        restore(str(tmp_path), 1, t, device="cpu")


def test_short_rows_vs_manifest_raises_typed_error(tmp_path):
    t = _tree()
    save(str(tmp_path), 2, t)
    victim = os.path.join(str(tmp_path), "step_2", "a.npy")
    np.save(victim, to_numpy(t["a"])[:1])
    with pytest.raises(CorruptSnapshotError, match="shape"):
        restore(str(tmp_path), 2, t, device="cpu")


def test_torn_manifest_json_raises_typed_error(tmp_path):
    save(str(tmp_path), 5, _tree())
    man = os.path.join(str(tmp_path), "step_5", "manifest.json")
    with open(man, "w") as f:
        f.write('{"step": 5, "leav')   # torn mid-write
    with pytest.raises(CorruptSnapshotError, match="manifest"):
        read_manifest(str(tmp_path), 5)


def test_sweep_tmp_removes_droppings_and_keeps_landed(tmp_path):
    save(str(tmp_path), 1, _tree())
    for n in (2, 9):
        d = os.path.join(str(tmp_path), f".tmp_{n}")
        os.makedirs(d)
        with open(os.path.join(d, "partial.npy"), "wb") as f:
            f.write(b"\x00" * 8)
    assert sweep_tmp(str(tmp_path)) == [2, 9]
    assert not any(x.startswith(".tmp") for x in os.listdir(tmp_path))
    assert list_steps(str(tmp_path)) == [1]
    assert sweep_tmp(str(tmp_path)) == []          # idempotent
    assert sweep_tmp(str(tmp_path / "missing")) == []
    assert latest_step(str(tmp_path / "missing")) is None


def test_run_store_sweeps_tmp_on_open(tmp_path):
    d = os.path.join(str(tmp_path), ".tmp_4")
    os.makedirs(d)
    store = RunStore(str(tmp_path))
    assert not os.path.exists(d)
    assert store.completed() == []
    assert store.manifest(0) is None


# ---------------------------------------------------------------------------
# across the packages: one format
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", list(_np_trees()))
def test_reference_snapshot_restores_in_the_port(tmp_path, case):
    tree = _np_trees()[case]
    ref_ckpt.save(str(tmp_path), 3, tree, extra={"note": case})
    out = restore(str(tmp_path), 3, tree, device="cpu")
    _same(out, tree)
    assert read_manifest(str(tmp_path), 3)["extra"] == {"note": case}


@pytest.mark.parametrize("case", list(_np_trees()))
def test_port_snapshot_restores_in_the_reference(tmp_path, case):
    tree = _np_trees()[case]
    save(str(tmp_path), 4, _to_torch(tree), extra={"note": case})
    out = ref_ckpt.restore(str(tmp_path), 4, tree)
    _same([np.asarray(x) for x in _flat(out)], _flat(tree))
    assert ref_ckpt.read_manifest(str(tmp_path), 4)["extra"] == \
        {"note": case}


@pytest.mark.parametrize("case", list(_np_trees()))
def test_manifest_lists_the_reference_leaves(tmp_path, case):
    """The same tree saved by each package: the same manifest (names,
    order, files, shapes, dtype strings, extra) and the same .npy bytes."""
    tree = _np_trees()[case]
    extra = {"chunk_id": 2, "min_key": [1, 2], "max_key": None}
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    ref_ckpt.save(str(ref_dir), 9, tree, extra=extra)
    save(str(port_dir), 9, tree, extra=extra)
    with open(ref_dir / "step_9" / "manifest.json") as f:
        want = json.load(f)
    with open(port_dir / "step_9" / "manifest.json") as f:
        got = json.load(f)
    assert got == want
    for leaf in want["leaves"]:
        assert (port_dir / "step_9" / leaf["file"]).read_bytes() == \
            (ref_dir / "step_9" / leaf["file"]).read_bytes()


def test_torch_uint32_leaves_save_as_the_reference_reads_them(tmp_path):
    u = np.array([[0, 1], [0xFFFFFFFF, 0x80000000]], np.uint32)
    save(str(tmp_path), 1, {"keys": to_device(u, "cpu"),
                            "lengths": torch.tensor([3, 4],
                                                    dtype=torch.int32)})
    leaves = read_manifest(str(tmp_path), 1)["leaves"]
    assert [(e["name"], e["dtype"]) for e in leaves] == \
        [("keys", "uint32"), ("lengths", "int32")]
    out = ref_ckpt.restore(str(tmp_path), 1,
                           {"keys": u, "lengths": np.zeros(2, np.int32)})
    np.testing.assert_array_equal(np.asarray(out["keys"]), u)
    back = restore(str(tmp_path), 1, {"keys": u, "lengths": u[0]},
                   device="cpu")
    assert back["keys"].dtype == torch.uint32
    np.testing.assert_array_equal(to_numpy(back["keys"]), u)


# ---------------------------------------------------------------------------
# ElasticSupervisor (tests/test_checkpoint.py and tests/test_failure.py)
# ---------------------------------------------------------------------------

def _elastic_trace(pkg, mgr, state0, new_state, to_float):
    injector = pkg.FailureInjector(fail_at_steps=[7], failed_devices=2)
    trace = []

    def run_segment(state, start, devices):
        s = state
        for step in range(start, 12):
            injector.check(step)
            s = new_state(s, step)
            trace.append((step, devices))
            if (step + 1) % 3 == 0:
                mgr.save(step + 1, s)
        return s

    def remesh(devices):
        step, s = mgr.restore_latest(state0) if pkg is ref_runtime \
            else mgr.restore_latest(state0, device="cpu")
        return (step, s) if step is not None else None


    sup = pkg.ElasticSupervisor(mgr, initial_devices=8)
    final = sup.run(run_segment, remesh, state0, 0)
    return (trace, [(e.step, e.devices_before, e.devices_after)
                    for e in sup.events], to_float(final["x"]))


def test_elastic_supervisor_recovers_as_the_reference(tmp_path):
    """A failure at step 7 on 8 devices: restore the step-6 snapshot, go on
    with 6 — the port's trace, events and state are the reference's."""
    got = _elastic_trace(
        port_runtime,
        CheckpointManager(str(tmp_path / "port"), keep=3, async_save=False),
        {"x": torch.zeros(()),
         "step_seen": torch.zeros((), dtype=torch.int32)},
        lambda s, step: {"x": s["x"] + 1.0,
                         "step_seen": torch.tensor(step, dtype=torch.int32)},
        float)
    want = _elastic_trace(
        ref_runtime,
        ref_ckpt.CheckpointManager(str(tmp_path / "ref"), keep=3,
                                   async_save=False),
        {"x": jnp.zeros(()), "step_seen": jnp.zeros((), jnp.int32)},
        lambda s, step: {"x": s["x"] + 1.0, "step_seen": jnp.int32(step)},
        float)
    assert got == want
    trace, events, x = got
    assert events == [(6, 8, 6)]
    assert [t for t in trace if t[1] == 6][0][0] == 6
    assert x == 12.0


class _FakeCkpt:
    def wait(self):
        pass


def _remesh_factory(snapshots):
    def remesh(devices):
        return snapshots[-1] if snapshots else None
    return remesh


def test_elastic_shrink_below_min_devices_raises():
    sup = ElasticSupervisor(_FakeCkpt(), initial_devices=4, min_devices=3)

    def run_segment(state, step, devices):
        raise DeviceFailure("two nodes gone", failed_devices=2)

    with pytest.raises(RuntimeError,
                       match="insufficient surviving devices") as ei:
        sup.run(run_segment, _remesh_factory([(0, {})]), {}, 0)
    assert isinstance(ei.value.__cause__, DeviceFailure)
    assert sup.devices == 4 and sup.events == []


def test_elastic_max_recoveries_exhaustion_chains_original():
    sup = ElasticSupervisor(_FakeCkpt(), initial_devices=16,
                            max_recoveries=3)
    calls = []

    def run_segment(state, step, devices):
        calls.append(devices)
        raise DeviceFailure(f"flaky at {devices}", failed_devices=1)

    with pytest.raises(RuntimeError, match="exceeded max recoveries") as ei:
        sup.run(run_segment, _remesh_factory([(0, {})]), {}, 0)
    assert isinstance(ei.value.__cause__, DeviceFailure)
    assert calls == [16, 15, 14, 13]
    assert len(sup.events) == 3


def test_elastic_recovery_event_bookkeeping():
    sup = ElasticSupervisor(_FakeCkpt(), initial_devices=8)
    attempts = []

    def run_segment(state, step, devices):
        attempts.append((step, devices))
        if len(attempts) == 1:
            raise DeviceFailure("one gone", failed_devices=1)
        if len(attempts) == 2:
            raise DeviceFailure("two gone", failed_devices=2)
        return state, step

    final = sup.run(run_segment, _remesh_factory([(5, "S")]), "S0", 0)
    assert final == ("S", 5)
    assert [(e.devices_before, e.devices_after) for e in sup.events] == \
        [(8, 7), (7, 5)]
    assert all(e.step == 5 for e in sup.events)
    assert attempts == [(0, 8), (5, 7), (5, 5)]


def test_elastic_restartable_keeps_world_size():
    sup = ElasticSupervisor(_FakeCkpt(), initial_devices=1,
                            restartable=True)
    attempts = []

    def run_segment(state, step, devices):
        attempts.append((step, devices))
        if len(attempts) == 1:
            raise DeviceFailure("process died", failed_devices=1)
        return state, step

    assert sup.run(run_segment, _remesh_factory([(7, "S")]), "S0", 0) == \
        ("S", 7)
    assert attempts == [(0, 1), (7, 1)]
    assert [(e.devices_before, e.devices_after) for e in sup.events] == \
        [(1, 1)]
    with pytest.raises(RuntimeError, match="no checkpoint"):
        ElasticSupervisor(_FakeCkpt(), initial_devices=2).run(
            lambda *a: (_ for _ in ()).throw(DeviceFailure("x")),
            _remesh_factory([]), "S0", 0)


def test_failure_injector_fires_once():
    inj = FailureInjector(fail_at_steps=[2], failed_devices=3)
    inj.check(1)
    with pytest.raises(DeviceFailure) as ei:
        inj.check(2)
    assert ei.value.failed_devices == 3
    inj.check(2)


# ---------------------------------------------------------------------------
# StragglerMonitor, against the reference's on the same durations
# ---------------------------------------------------------------------------

def _durations(seed):
    rng = np.random.default_rng(seed)
    d = list(0.1 + 0.01 * rng.random(40))
    d[25] = 5.0                              # a one-off straggler
    d += [1.0 + 0.001 * (i % 3) for i in range(12)]   # a regime shift
    d += [30.0, 1.0]
    return d


@pytest.mark.parametrize("seed", [0, 1])
def test_straggler_monitor_matches_the_reference(seed):
    kw = dict(threshold=3.0, warmup=5, rebaseline_after=4)
    port, ref = StragglerMonitor(**kw), ref_runtime.StragglerMonitor(**kw)
    for step, d in enumerate(_durations(seed)):
        assert port.record(step, d) == ref.record(step, d)
        assert port.cutoff() == ref.cutoff()
    assert port.flagged == ref.flagged and port.flagged
    assert port.rebaselines == ref.rebaselines and port.rebaselines
    assert (port.mean, port.var, port.count) == (ref.mean, ref.var, ref.count)


def test_straggler_monitor_flags_outlier():
    mon = StragglerMonitor(threshold=3.0, warmup=5)
    flagged = []
    mon.on_straggler = lambda step, d, z: flagged.append(step)
    for s in range(20):
        mon.record(s, 0.1 + 0.001 * (s % 3))
    assert mon.record(20, 5.0) is True
    assert flagged == [20]
    assert mon.record(21, 0.1) is False


def test_straggler_one_off_does_not_rebaseline():
    mon = StragglerMonitor(threshold=3.0, warmup=5, rebaseline_after=3)
    for s in range(15):
        mon.record(s, 0.1)
    assert mon.record(15, 5.0) is True
    assert mon.record(16, 0.1) is False
    assert mon.record(17, 5.0) is True
    assert mon.record(18, 0.1) is False
    assert mon.rebaselines == []
    assert mon.mean == pytest.approx(0.1, rel=0.05)


def test_monitor_cutoff_warmup_then_relative_floor():
    mon = StragglerMonitor(warmup=3, min_ratio=1.5)
    assert mon.cutoff() is None
    for s in range(3):
        mon.record(s, 0.2)
    assert mon.cutoff() == pytest.approx(0.3, rel=0.05)
