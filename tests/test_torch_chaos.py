"""The port's seeded chaos soak (``repro_torch.runtime.chaos``) against the
reference's (``repro.runtime.chaos``): the same seed gives the same plan,
field by field; the same plan inflicts the same damage on equal stores; and
the 25-seed soak over CPU destinations repeated 8 ways ends every seed
bit-identical to the no-fault oracle — which is the reference's own mesh
sort of the same words."""

import filecmp
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from repro.core.distributed import \
    distributed_chunked_sort_lex as ref_chunked_sort
from repro.runtime import apply_damages as ref_apply_damages
from repro.runtime import make_plan as ref_make_plan
from repro_torch.core.distributed import distributed_chunked_sort_lex
from repro_torch.core.packing import pack_words
from repro_torch.interop import to_numpy
from repro_torch.pipeline import RunStore, ShardStore
from repro_torch.runtime import ChaosPlan, apply_damages, chaos_soak, make_plan
from repro_torch.runtime.chaos import _STAGE_OCCS, TYPED_ERRORS

SEEDS = range(25)
DEVS8 = [torch.device("cpu")] * 8


def _keys(n=200, seed=0):
    rng = np.random.default_rng(seed)
    alpha = list("abcdefgh")
    words = ["".join(rng.choice(alpha, l)) for l in rng.integers(0, 9, n)]
    return np.asarray(pack_words(words))


KEYS = _keys()


# ---------------------------------------------------------------------------
# plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("num_devices", [4, 8])
def test_make_plan_equals_the_reference(seed, num_devices):
    got = make_plan(seed, num_devices=num_devices)
    want = ref_make_plan(seed, num_devices=num_devices)
    assert isinstance(got, ChaosPlan)
    for field in ("seed", "validate", "fail_at", "timeout_at", "kill_at",
                  "device_fail_at", "damages", "max_retries"):
        assert getattr(got, field) == getattr(want, field), field
    assert got == make_plan(seed, num_devices=num_devices)


def test_plans_stay_within_retry_budget_and_reach_their_stages():
    for seed in range(200):
        p = make_plan(seed)
        per_stage = {}
        for stage, occ in p.fail_at + p.timeout_at:
            per_stage[stage] = per_stage.get(stage, 0) + 1
        assert all(n <= p.max_retries for n in per_stage.values()), seed
        for stage, occ in p.fail_at + p.timeout_at + p.kill_at:
            assert 0 <= occ < _STAGE_OCCS[stage], (seed, stage, occ)


def test_plan_population_covers_required_fault_classes():
    plans = [make_plan(s) for s in SEEDS]
    assert {st for p in plans for st, _ in p.kill_at} == {
        "ingest_chunk", "run_exchange", "streaming_combine"}
    assert {"tmp", "truncate", "short_rows", "bitflip"} <= {
        k for p in plans for k, _ in p.damages}
    assert {p.validate for p in plans} == {"cheap", "full"}
    for p in plans:
        for kind, store in p.damages:
            if kind == "bitflip":
                assert p.validate == "full" and store == "shards"


def test_typed_errors_are_the_fault_taxonomy():
    names = {t.__name__ for t in TYPED_ERRORS()}
    assert names == {"StageFailure", "DeviceFailure", "CapacityOverflow",
                     "ProcessKilled", "ValidationError",
                     "CorruptSnapshotError"}


# ---------------------------------------------------------------------------
# damages
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def landed(tmp_path_factory):
    """A run store and a shard store after one full port sort."""
    base = tmp_path_factory.mktemp("landed")
    distributed_chunked_sort_lex(
        KEYS, devices=DEVS8, store=RunStore(str(base / "runs")),
        shard_store=ShardStore(str(base / "shards")))
    return base


_DAMAGED_SEEDS = [s for s in range(40) if make_plan(s).damages]


@pytest.mark.parametrize("seed", _DAMAGED_SEEDS[:12])
def test_same_damages_on_equal_stores(seed, landed, tmp_path):
    """Two copies of one pair of stores, one damaged by each package's
    ``apply_damages`` under the same plan: the same files hit, the same
    bytes left behind."""
    copies = {}
    for side in ("port", "ref"):
        shutil.copytree(landed, tmp_path / side)
        copies[side] = (str(tmp_path / side / "runs"),
                        str(tmp_path / side / "shards"))
    got = apply_damages(make_plan(seed), *copies["port"])
    want = ref_apply_damages(ref_make_plan(seed), *copies["ref"])
    rel = lambda pairs, side: [(k, os.path.relpath(p, tmp_path / side))  # noqa
                               for k, p in pairs]
    assert rel(got, "port") == rel(want, "ref")
    assert got, "the plan's damage found nothing to hit"
    for root, _dirs, files in os.walk(tmp_path / "port"):
        other = os.path.join(tmp_path / "ref",
                             os.path.relpath(root, tmp_path / "port"))
        for f in files:
            assert filecmp.cmp(os.path.join(root, f),
                               os.path.join(other, f), shallow=False), f


# ---------------------------------------------------------------------------
# the soak
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def soak(tmp_path_factory):
    return chaos_soak(KEYS, seeds=SEEDS,
                      workdir=str(tmp_path_factory.mktemp("soak")),
                      devices=DEVS8, num_devices=8)


@pytest.fixture(scope="module")
def ref_oracle():
    run = ref_chunked_sort(KEYS, devices=[jax.devices()[0]] * 8)
    return np.asarray(run.lengths), np.asarray(run.keys)


def test_port_oracle_is_the_reference_output(ref_oracle):
    run = distributed_chunked_sort_lex(KEYS, devices=DEVS8)
    np.testing.assert_array_equal(to_numpy(run.lengths), ref_oracle[0])
    np.testing.assert_array_equal(to_numpy(run.keys), ref_oracle[1])


@pytest.mark.parametrize("seed", SEEDS)
def test_soak_seed_ends_bit_identical(seed, soak):
    """Each schedule ends bit-identical to the oracle, directly or through
    a typed-error resume; invocation 1 dies with nothing untyped."""
    report = soak[seed]
    assert report.seed == seed and report.plan == make_plan(seed, 8)
    assert report.ok, (report.first_error, report.detail)
    assert not (report.first_error or "").startswith("UNTYPED")
    if report.first_error is not None:
        assert report.resumed


def test_soak_population_hit_every_stage_and_damage(soak):
    fired = [(st, kind) for r in soak for (st, _o, kind) in r.fired]
    kill_stages = {st for st, kind in fired if kind == "kill"}
    assert {"run_exchange", "streaming_combine"} <= kill_stages
    assert any(kind == "timeout" for _st, kind in fired)
    assert "truncate" in {k for r in soak for (k, _p) in r.damaged}
    assert sum(r.resumed for r in soak) >= 10
