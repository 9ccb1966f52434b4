"""Seeded chaos soak harness for the crash-anywhere distributed sort — the
counterpart of ``repro.runtime.chaos``: the same plans from the same seeds
(the same ``np.random.default_rng`` draws in the same order), the same
damages on the same store files, driving the port's
``core.distributed.distributed_chunked_sort_lex``.

The fault-tolerance claim of ``core.distributed.distributed_chunked_sort_
lex`` is an *anywhere* claim: whatever combination of transient stage
failures, injected timeouts, process kills at stage boundaries, and
post-write artifact damage (torn ``.tmp`` droppings, truncated or
short-row ``.npy`` files, bit flips) hits the job, it must either complete
bit-identical to the no-fault oracle or die with a *typed* error leaving
stores from which a second invocation resumes bit-identically. Hand-picked
fault tests can't cover that product space; this module samples it:

  * :func:`make_plan` derives one randomized-but-deterministic
    :class:`ChaosPlan` per seed (``np.random.default_rng(seed)`` — same
    seed, same schedule, forever): an injector schedule over the pipeline's
    stages plus a list of post-mortem store damages;
  * :func:`apply_damages` inflicts the plan's damage on whatever artifacts
    the (possibly killed) first invocation left behind — the seeded chaos
    equivalent of a disk that lies;
  * :func:`chaos_soak` drives N seeds: invocation 1 under the injector,
    damage, then invocation 2 against the same stores with no injector —
    asserting the resume lands bit-identical to the oracle. Only *typed*
    errors (the fault taxonomy: ``StageFailure``/``StageTimeout``,
    ``DeviceFailure``, ``CapacityOverflow``, ``ProcessKilled``,
    ``ValidationError``, ``CorruptSnapshotError``) are acceptable from
    invocation 1 — a bare numpy or torch exception is a soak failure.

Damage-kind semantics (each self-heals on resume through a different
guard, which is the point):

  ``tmp``         a half-written ``.tmp_*`` snapshot dropping — swept on
                  store open, never mistaken for landed data
  ``truncate``    a landed ``.npy`` binarily truncated (torn by external
                  damage) — ``CorruptSnapshotError`` at load, recompute
  ``short_rows``  a *valid* ``.npy`` with fewer rows than the snapshot
                  manifest records — shape-vs-manifest mismatch raises
                  ``CorruptSnapshotError``, recompute
  ``bitflip``     one flipped payload bit in a shard's ``keys.npy`` —
                  loadable, count-correct, possibly still sorted; only the
                  ``validate='full'`` digest gate can prove it wrong, so
                  plans pair bit flips with full validation (shards only:
                  the shard-resume gate recomputes on digest mismatch)
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Optional, Sequence, Tuple

import numpy as np

from ..checkpoint.manager import CorruptSnapshotError
from .failure import CapacityOverflow, DeviceFailure
from .sortfault import (ProcessKilled, RetryPolicy, SortSupervisor,
                        StageFailure, StageFailureInjector)

__all__ = ["TYPED_ERRORS", "ChaosPlan", "SoakReport", "make_plan",
           "apply_damages", "chaos_soak"]

log = logging.getLogger("repro_torch.runtime")

# the full fault taxonomy — everything invocation 1 is *allowed* to die
# with (ValidationError is imported lazily: the pipeline imports the
# device stack, which this module's import graph stays off until soak time)
def _typed_errors():
    from ..pipeline.validate import ValidationError
    return (StageFailure, DeviceFailure, CapacityOverflow, ProcessKilled,
            ValidationError, CorruptSnapshotError)


TYPED_ERRORS = _typed_errors  # callable: resolved at soak time


# the stages distributed_chunked_sort_lex runs through the supervisor, with
# the occurrence range a D-device soak can reach (ingest + combine run once
# per device/destination; the exchange once, plus capacity retries)
_STAGE_OCCS = {"ingest_chunk": 4, "run_exchange": 1, "streaming_combine": 4}
_DAMAGE_KINDS = ("tmp", "truncate", "short_rows", "bitflip")


@dataclasses.dataclass(frozen=True)
class ChaosPlan:
    """One seed's fault schedule: deterministic injector maps (stage ->
    occurrence indices), post-run store damages (``(kind, store)`` with
    store ``'runs'`` or ``'shards'``), and the validation mode the sort
    runs under. ``make_plan(seed)`` is a pure function of the seed."""

    seed: int
    validate: str                                   # 'cheap' | 'full'
    fail_at: Tuple[Tuple[str, int], ...]            # transient
    timeout_at: Tuple[Tuple[str, int], ...]         # injected deadline hit
    kill_at: Tuple[Tuple[str, int], ...]            # simulated SIGKILL
    device_fail_at: Tuple[Tuple[str, int], ...]     # device loss (aborts)
    damages: Tuple[Tuple[str, str], ...]            # (kind, store)
    max_retries: int = 3

    def _as_map(self, pairs):
        out: dict = {}
        for stage, occ in pairs:
            out.setdefault(stage, set()).add(occ)
        return out

    def injector(self) -> StageFailureInjector:
        return StageFailureInjector(
            fail_at=self._as_map(self.fail_at),
            timeout_at=self._as_map(self.timeout_at),
            kill_at=self._as_map(self.kill_at),
            device_fail_at=self._as_map(self.device_fail_at))


def make_plan(seed: int, num_devices: int = 4) -> ChaosPlan:
    """Derive the seed's :class:`ChaosPlan`. Deterministic: the same seed
    always yields the same schedule (the soak's reproducibility contract —
    a red seed in CI replays locally verbatim)."""
    rng = np.random.default_rng(seed)
    occs = {s: min(m, max(1, num_devices))
            for s, m in _STAGE_OCCS.items()}
    stages = sorted(occs)

    def draw_faults(n):
        out = []
        for _ in range(n):
            s = stages[int(rng.integers(len(stages)))]
            out.append((s, int(rng.integers(occs[s]))))
        return tuple(out)

    # draw order is part of the plan's identity — never reorder these
    validate = "full" if rng.random() < 0.5 else "cheap"
    fail_at = draw_faults(int(rng.integers(0, 3)))
    timeout_at = draw_faults(int(rng.integers(0, 2)))
    kill_at = ()
    if rng.random() < 0.6:
        s = stages[int(rng.integers(len(stages)))]
        kill_at = ((s, int(rng.integers(occs[s]))),)
    device_fail_at = ()
    if rng.random() < 0.15:
        s = stages[int(rng.integers(len(stages)))]
        device_fail_at = ((s, int(rng.integers(occs[s]))),)
    kinds = [k for k in _DAMAGE_KINDS
             if k != "bitflip" or validate == "full"]
    damages = tuple(
        (kinds[int(rng.integers(len(kinds)))],
         "shards" if rng.random() < 0.7 else "runs")
        for _ in range(int(rng.integers(0, 3))))
    # bit flips in the ingest-run store are undetectable by construction
    # when the manifest still matches the input chunk (the sorted bytes
    # changed, the multiset digest of the *input* didn't have to) — shards
    # are where the digest gate re-proves content, so flips go there only
    damages = tuple((k, "shards" if k == "bitflip" else st)
                    for k, st in damages)
    return ChaosPlan(seed=int(seed), validate=validate, fail_at=fail_at,
                     timeout_at=timeout_at, kill_at=kill_at,
                     device_fail_at=device_fail_at, damages=damages)


def _landed_npys(directory: str, min_size: int = 0) -> list:
    out = []
    if not os.path.isdir(directory):
        return out
    for step in sorted(os.listdir(directory)):
        d = os.path.join(directory, step)
        if not step.startswith("step_") or not os.path.isdir(d):
            continue
        for f in sorted(os.listdir(d)):
            p = os.path.join(d, f)
            if f.endswith(".npy") and os.path.getsize(p) > min_size:
                out.append(p)
    return out


def apply_damages(plan: ChaosPlan, run_dir: str, shard_dir: str) -> list:
    """Inflict the plan's damages on whatever the first invocation left
    behind. Damage targets are drawn from the plan's own rng stream (offset
    by the damage index) over the files that actually exist — a kill early
    in the pipeline simply leaves less to damage. Returns ``(kind, path)``
    pairs for the damages actually applied."""
    applied = []
    for i, (kind, which) in enumerate(plan.damages):
        rng = np.random.default_rng((plan.seed << 8) + i)
        base = shard_dir if which == "shards" else run_dir
        if kind == "tmp":
            tmp = os.path.join(base, ".tmp_7")
            os.makedirs(tmp, exist_ok=True)
            with open(os.path.join(tmp, "junk.npy"), "wb") as f:
                f.write(b"\x00" * 16)
            applied.append((kind, tmp))
            continue
        # keys.npy only: big enough to damage meaningfully, and the guards
        # under test (shape check, digest gate) all watch the key tensor
        cands = [p for p in _landed_npys(base, min_size=256)
                 if p.endswith("keys.npy")]
        if not cands:
            continue
        path = cands[int(rng.integers(len(cands)))]
        size = os.path.getsize(path)
        if kind == "truncate":
            with open(path, "r+b") as f:
                f.truncate(int(rng.integers(1, max(2, size // 2))))
        elif kind == "short_rows":
            arr = np.load(path)
            if arr.shape[0] < 2:
                continue
            np.save(path, arr[: arr.shape[0] // 2])
        elif kind == "bitflip":
            # flip one bit in the data region (past the ~128-byte header)
            off = int(rng.integers(200, size))
            with open(path, "r+b") as f:
                f.seek(off)
                byte = f.read(1)[0]
                f.seek(off)
                f.write(bytes([byte ^ (1 << int(rng.integers(8)))]))
        applied.append((kind, path))
    return applied


@dataclasses.dataclass
class SoakReport:
    """Outcome of one seed: what invocation 1 died with (``None`` = it
    completed), which faults actually fired, what damage landed, and
    whether the final state is bit-identical to the oracle."""

    seed: int
    plan: ChaosPlan
    first_error: Optional[str]
    fired: Tuple[Tuple[str, int, str], ...]
    damaged: Tuple[Tuple[str, str], ...]
    resumed: bool
    ok: bool
    detail: str = ""


def _materialize(result, validate: str, device):
    """Gathered ``SortedRun`` or spilled ``ShardedRun`` -> host arrays."""
    from ..pipeline.validate import host
    run = result.to_run(validate=validate, device=device) \
        if hasattr(result, "to_run") else result
    return host(run.lengths), host(run.keys)


def chaos_soak(keys, seeds: Sequence[int], workdir: str, devices=None,
               merge_engine: str = "auto",
               num_devices: int = 4) -> list:
    """Run the soak: for each seed, invocation 1 of
    ``distributed_chunked_sort_lex`` under the seed's injector (jittered
    retry policy, no real sleeps), then the plan's store damages, then
    invocation 2 against the same directories with no injector. Every seed
    must end bit-identical to the no-fault oracle — either directly (the
    faults were all recoverable in-process) or through the resume — and
    invocation 1 may only die with a typed error. ``devices``: the
    destinations (``distributed_chunked_sort_lex``'s; default every local
    card). Returns one :class:`SoakReport` per seed; ``all(r.ok for r in
    reports)`` is the soak verdict."""
    from ..core.distributed import (_chunk_devices,
                                    distributed_chunked_sort_lex)
    from ..pipeline.manifest import RunStore
    from ..pipeline.shards import ShardStore
    from ..pipeline.validate import host
    typed = TYPED_ERRORS()
    devices = _chunk_devices(None, None, devices)

    oracle = distributed_chunked_sort_lex(keys, devices=devices,
                                          merge_engine=merge_engine,
                                          validate="off")
    o_lengths, o_keys = host(oracle.lengths), host(oracle.keys)

    reports = []
    for seed in seeds:
        plan = make_plan(seed, num_devices=num_devices)
        run_dir = os.path.join(workdir, f"seed_{seed}", "runs")
        shard_dir = os.path.join(workdir, f"seed_{seed}", "shards")
        sup = SortSupervisor(
            policy=RetryPolicy(max_retries=plan.max_retries,
                               backoff_base=0.01, jitter=1.0, seed=seed),
            injector=plan.injector(), sleep=lambda _s: None)
        first_error, detail = None, ""
        try:
            res = distributed_chunked_sort_lex(
                keys, devices=devices, algorithm="pallas",
                store=RunStore(run_dir), shard_store=ShardStore(shard_dir),
                supervisor=sup, validate=plan.validate,
                merge_engine=merge_engine)
        except typed as e:
            first_error = type(e).__name__
            detail = str(e)
        except Exception as e:   # untyped: the soak contract is broken
            reports.append(SoakReport(
                seed=int(seed), plan=plan,
                first_error=f"UNTYPED:{type(e).__name__}",
                fired=tuple(sup.injector.fired), damaged=(),
                resumed=False, ok=False, detail=str(e)))
            continue

        damaged = tuple(apply_damages(plan, run_dir, shard_dir))
        resumed = first_error is not None or bool(damaged)
        try:
            res2 = distributed_chunked_sort_lex(
                keys, devices=devices, algorithm="pallas",
                store=RunStore(run_dir), shard_store=ShardStore(shard_dir),
                supervisor=SortSupervisor(), validate=plan.validate,
                merge_engine=merge_engine)
            lengths, kk = _materialize(res2, plan.validate, devices[0])
            ok = (np.array_equal(lengths, o_lengths)
                  and np.array_equal(kk, o_keys))
            if not ok:
                detail = "resume output differs from oracle"
        except Exception as e:
            ok = False
            detail = f"resume raised {type(e).__name__}: {e}"
        reports.append(SoakReport(
            seed=int(seed), plan=plan, first_error=first_error,
            fired=tuple(sup.injector.fired), damaged=damaged,
            resumed=resumed, ok=ok, detail=detail))
        log.info("chaos seed %s: first_error=%s fired=%d damaged=%d ok=%s",
                 seed, first_error, len(sup.injector.fired), len(damaged),
                 ok)
    return reports
