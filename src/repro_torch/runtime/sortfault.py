"""Stage-level fault injection + supervised recovery for the sort engine —
the counterpart of ``repro.runtime.sortfault``.

``runtime/failure.py`` models whole-job elasticity for the *training* loop
(checkpoint/restart on ``DeviceFailure``). The sort pipeline fails at finer
granularity — one chunk launch, one collective exchange, one merge round —
and each stage has a cheaper recovery than a full restart:

  stage             injected fault        recovery
  ----------------- --------------------- ----------------------------------
  ingest_chunk      StageFailure          re-launch the chunk (backoff retry)
  merge_round       StageFailure          re-run the round (rounds are pure)
  run_exchange      StageFailure          re-run the whole-run exchange (the
                                          boundary split and slicing are
                                          pure functions of the runs)
  streaming_combine StageFailure          re-run the one-launch k-way merge
                                          (pure function of its input runs)
  any stage         StageTimeout          the stage exceeded its wall-clock
                                          deadline — abandon the launch and
                                          re-run (same retry budget as a
                                          transient failure)
  any stage         ProcessKilled         NOT recoverable in-process: the
                                          simulated SIGKILL propagates; a
                                          fresh invocation resumes from the
                                          durable stores
  exchange          DeviceFailure         shrink mesh, re-run the sample
                                          sort on the survivors
  exchange          CapacityOverflow      double the exchange capacity and
                                          retry (never drop elements)

:class:`StageFailureInjector` produces those faults deterministically (by
stage name + occurrence index, each fires exactly once), so tests can kill
the pipeline mid-flight and assert the recovered output is bit-identical to
the no-failure oracle. :class:`SortSupervisor` runs the recovery:
bounded exponential-backoff retry (with optional seeded full jitter, so
simultaneous per-destination retries decollide deterministically) for
transient stage failures, per-stage wall-clock **deadlines** (a stage that
hangs becomes a retryable :class:`StageTimeout` instead of a stuck job),
**speculative re-execution** for straggling combine stages
(:class:`SpeculationPolicy` over ``runtime.straggler.StragglerMonitor`` —
first successful completion wins, the loser is discarded only after its
output digest matches), ``ElasticSupervisor``-style mesh shrink for device
loss, and capacity doubling for overflow. Every recovery is recorded in
``events`` for observability and test bookkeeping.

On the card, a stage that runs on a worker thread (a deadline, a
speculative replica) runs on the calling thread's CUDA device and current
stream: PyTorch keeps both per thread, and the stage's kernels must queue
behind the caller's work (a chunk's upload, the previous stage). Kernel
launches return before the device finishes, so a deadline bounds a stage's
host call — its launches — as it does in the reference, whose JAX dispatch
is asynchronous too; no synchronisation is added. An abandoned launch keeps
running on the card beside its retry, and the two share no buffer: the
kernel wrappers on the sort's path allocate their outputs, scratch and
plans per call, and the row sorts (B1, B2, B4) sort in place the stacked
tensor ``ops`` builds for the call.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import logging
import time
import zlib
from typing import Callable, Optional

import torch

from .failure import CapacityOverflow, DeviceFailure

__all__ = ["KNOWN_STAGES", "StageFailure", "StageTimeout", "ProcessKilled",
           "SpeculationMismatch", "StageFailureInjector", "RetryPolicy",
           "StageEvent", "SpeculationPolicy", "SortSupervisor"]

log = logging.getLogger("repro_torch.runtime")

# The stage names the engine runs through SortSupervisor.run_stage — the
# valid keys for StageFailureInjector schedules (run_stage itself is generic
# over names; this tuple documents the wired surface and lets tests catch a
# schedule keyed on a stage that no longer exists).
KNOWN_STAGES = ("ingest_chunk", "merge_round", "run_exchange",
                "streaming_combine", "exchange")


class StageFailure(RuntimeError):
    """A transient failure of one pipeline stage execution (a failed kernel
    launch, a lost RPC) — retryable in place, unlike :class:`DeviceFailure`
    which requires a mesh rebuild."""

    def __init__(self, stage: str, occurrence: int, msg: str | None = None):
        super().__init__(msg or f"injected {stage} failure "
                                f"(occurrence {occurrence})")
        self.stage = stage
        self.occurrence = occurrence


class StageTimeout(StageFailure):
    """A stage exceeded its wall-clock deadline. Subclasses
    :class:`StageFailure` because the recovery is the same — abandon the
    launch and re-run the (pure) stage under the bounded retry budget —
    while the type lets tests and operators distinguish a hang from a
    crash."""

    def __init__(self, stage: str, deadline: float, occurrence: int = -1,
                 msg: str | None = None):
        super().__init__(stage, occurrence,
                         msg or f"stage {stage} exceeded its "
                                f"{deadline:.3g}s deadline")
        self.deadline = deadline


class ProcessKilled(RuntimeError):
    """Simulated SIGKILL at a stage boundary — deliberately NOT a
    :class:`StageFailure`: no in-process recovery exists for a dead
    process, so the supervisor must not retry it. The 'job' dies holding
    only what it durably persisted; chaos tests raise this mid-pipeline and
    then prove a fresh invocation resumes bit-identically from the
    stores."""

    def __init__(self, stage: str, occurrence: int):
        super().__init__(f"process killed at {stage} "
                         f"(occurrence {occurrence})")
        self.stage = stage
        self.occurrence = occurrence


class SpeculationMismatch(RuntimeError):
    """Speculative re-execution produced a different output digest than the
    primary — the stage is supposed to be a pure function of its inputs, so
    disagreement means silent corruption on one path. Never swallowed: the
    job must fail loudly rather than pick a winner arbitrarily."""

    def __init__(self, stage: str, d_primary: int, d_backup: int):
        super().__init__(
            f"speculative {stage} outputs disagree: primary digest "
            f"{d_primary:#018x} != backup {d_backup:#018x}")
        self.stage = stage


class StageFailureInjector:
    """Deterministic per-stage failure schedule.

    ``fail_at``: mapping ``stage -> iterable of occurrence indices`` that
    raise :class:`StageFailure` (transient — a supervisor retries in place).
    ``device_fail_at``: same shape, raising :class:`DeviceFailure` with
    ``failed_devices`` lost (a supervisor shrinks the mesh).
    ``timeout_at``: same shape, raising :class:`StageTimeout` (a simulated
    deadline expiry — retried like a transient failure). ``kill_at``: same
    shape, raising :class:`ProcessKilled` (never retried — the whole
    invocation dies at the stage boundary). ``slow_at``: mapping ``stage ->
    {occurrence: seconds}`` — the stage *runs* but only after a real sleep,
    so supervisor deadlines and speculation cutoffs fire against genuine
    wall-clock slowness. ``check(stage)`` counts every call per stage; each
    scheduled fault fires exactly once, so the retry of a failed occurrence
    succeeds — mirroring ``runtime.failure.FailureInjector``'s fire-once
    contract at stage granularity. Returns the slow-sleep seconds to apply
    (or ``None``); callers that execute stages themselves may ignore it.
    """

    def __init__(self, fail_at=None, device_fail_at=None,
                 failed_devices: int = 1, timeout_at=None, kill_at=None,
                 slow_at=None):
        self.fail_at = {s: set(ix) for s, ix in (fail_at or {}).items()}
        self.device_fail_at = {s: set(ix)
                               for s, ix in (device_fail_at or {}).items()}
        self.timeout_at = {s: set(ix) for s, ix in (timeout_at or {}).items()}
        self.kill_at = {s: set(ix) for s, ix in (kill_at or {}).items()}
        self.slow_at = {s: dict(m) for s, m in (slow_at or {}).items()}
        self.failed_devices = failed_devices
        self.occurrences: dict[str, int] = {}
        self.fired: list[tuple[str, int, str]] = []

    def check(self, stage: str) -> Optional[float]:
        idx = self.occurrences.get(stage, 0)
        self.occurrences[stage] = idx + 1
        if idx in self.kill_at.get(stage, ()):
            self.kill_at[stage].discard(idx)
            self.fired.append((stage, idx, "kill"))
            raise ProcessKilled(stage, idx)
        if idx in self.device_fail_at.get(stage, ()):
            self.device_fail_at[stage].discard(idx)
            self.fired.append((stage, idx, "device"))
            raise DeviceFailure(
                f"injected device failure in {stage} (occurrence {idx})",
                self.failed_devices)
        if idx in self.timeout_at.get(stage, ()):
            self.timeout_at[stage].discard(idx)
            self.fired.append((stage, idx, "timeout"))
            raise StageTimeout(
                stage, deadline=0.0, occurrence=idx,
                msg=f"injected {stage} timeout (occurrence {idx})")
        if idx in self.fail_at.get(stage, ()):
            self.fail_at[stage].discard(idx)
            self.fired.append((stage, idx, "transient"))
            raise StageFailure(stage, idx)
        slow = self.slow_at.get(stage, {}).pop(idx, None)
        if slow is not None:
            self.fired.append((stage, idx, "slow"))
        return slow


def _on_callers_stream(fn: Callable) -> Callable:
    """``fn`` made to run on the calling thread's CUDA device and current
    stream from whichever thread calls it (``fn`` itself where CUDA is not
    in use)."""
    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return fn
    stream = torch.cuda.current_stream()

    def call(*args, **kwargs):
        with torch.cuda.device(stream.device), torch.cuda.stream(stream):
            return fn(*args, **kwargs)
    return call


_U64_MASK = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    """One splitmix64 step — the deterministic uniform stream behind the
    retry jitter (and the same finalizer ``pipeline/validate``'s digest
    uses, so the repo has exactly one PRNG idiom)."""
    x = (x + 0x9E3779B97F4A7C15) & _U64_MASK
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _U64_MASK
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _U64_MASK
    return (x ^ (x >> 31)) & _U64_MASK


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded exponential backoff for transient stage failures. The default
    base of 0 keeps tests instant; production callers set e.g.
    ``RetryPolicy(max_retries=5, backoff_base=0.5)`` for 0.5/1/2/4/8 s.

    ``jitter`` spreads simultaneous retries: ``delay = expo * (1 - jitter *
    u)`` with ``u`` uniform in [0, 1) drawn from a seeded splitmix64 stream
    — ``jitter=1.0`` is AWS-style full jitter (delays land anywhere in
    ``(0, expo]``), ``jitter=0.0`` (default) keeps the legacy exact
    schedule. The draw is a pure function of ``(seed, stream, attempt)``,
    so two destinations retrying the same stage decollide (the supervisor
    hands each stage invocation its own ``stream``) while any given
    schedule replays bit-identically — chaos runs stay reproducible."""

    max_retries: int = 3
    backoff_base: float = 0.0
    backoff_factor: float = 2.0
    jitter: float = 0.0
    seed: int = 0

    def delay(self, attempt: int, stream: int = 0) -> float:
        expo = self.backoff_base * (self.backoff_factor ** (attempt - 1))
        if not self.jitter:
            return expo
        mix = _splitmix64((self.seed & _U64_MASK)
                          ^ ((stream & _U64_MASK) * 0x9E3779B97F4A7C15
                             & _U64_MASK)
                          ^ (attempt & _U64_MASK))
        u = mix / float(1 << 64)
        return expo * (1.0 - self.jitter * u)


@dataclasses.dataclass
class StageEvent:
    """One recovery action, for observability and test assertions."""

    stage: str
    attempt: int
    action: str    # 'retry' | 'remesh' | 'capacity_double' | 'speculate'
                   # | 'speculation_confirmed' | 'speculation_loser_failed'
    detail: str


@dataclasses.dataclass
class SpeculationPolicy:
    """Speculative re-execution policy for straggling stages (MapReduce's
    backup tasks, at combine-destination granularity). The ``monitor``
    learns the stage's healthy duration (EWMA over completed executions);
    once warmed up, a primary execution that outlives ``monitor.cutoff()``
    gets a backup launched against the same inputs — first *successful*
    completion wins, and the loser is discarded only after its output
    digest matches the winner's (disagreement raises
    :class:`SpeculationMismatch`: the stage is pure, so divergence is
    corruption, not a race). ``min_wait`` floors the cutoff so microsecond
    EWMAs never fire spurious backups."""

    monitor: object                      # runtime.straggler.StragglerMonitor
    min_wait: float = 0.05
    max_backups: int = 1


class SortSupervisor:
    """Runs the recovery of the sort pipeline's stages.

    ``run_stage`` wraps one stage callable with the injector probe, the
    transient-retry policy, and (when ``deadlines`` names the stage) a
    wall-clock deadline — the stage runs on a worker thread and a
    ``future.result`` timeout converts a hang into a retryable
    :class:`StageTimeout`, the abandoned launch left to finish on its
    thread. ``run_speculative`` adds straggler-driven backup execution per
    :class:`SpeculationPolicy`. ``run_with_capacity`` escalates overflow
    into capacity doubling; ``run_distributed`` adds the mesh-shrink path
    for device loss during the sample-sort exchange. Pass the supervisor to
    ``pipeline.ingest.chunked_sort_*`` (which routes chunk sorts and merges
    through ``run_stage``) or call ``run_distributed`` around a mesh sort.
    """

    def __init__(self, policy: RetryPolicy = RetryPolicy(),
                 injector: Optional[StageFailureInjector] = None,
                 sleep: Callable[[float], None] = time.sleep,
                 deadlines: Optional[dict] = None,
                 speculation: Optional[SpeculationPolicy] = None):
        self.policy = policy
        self.injector = injector
        self.events: list[StageEvent] = []
        self._sleep = sleep
        self.deadlines = dict(deadlines or {})
        self.speculation = speculation
        self._stage_calls: dict[str, int] = {}

    def _next_stream(self, stage: str) -> int:
        """Per-invocation jitter stream: crc32 decorrelates stages, the
        per-stage call counter decorrelates the destinations that run the
        same stage — so full-jitter retries never re-collide, yet a replay
        of the same pipeline draws the same schedule."""
        idx = self._stage_calls.get(stage, 0)
        self._stage_calls[stage] = idx + 1
        return (zlib.crc32(stage.encode()) << 20) + idx

    def _execute(self, stage: str, fn: Callable, args, kwargs,
                 slow: Optional[float]):
        """One stage execution: apply any injected slow-sleep *inside* the
        deadline scope, and enforce the stage's deadline (if any) via a
        worker thread. ``shutdown(wait=False)`` abandons a timed-out launch
        instead of joining it — the retry must not block on the hang."""
        deadline = self.deadlines.get(stage)
        if deadline is None:
            if slow:
                time.sleep(slow)
            return fn(*args, **kwargs)
        fn = _on_callers_stream(fn)

        def call():
            if slow:
                time.sleep(slow)
            return fn(*args, **kwargs)

        ex = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        try:
            fut = ex.submit(call)
            try:
                return fut.result(timeout=deadline)
            except concurrent.futures.TimeoutError:
                raise StageTimeout(stage, deadline) from None
        finally:
            ex.shutdown(wait=False)

    # -------------------------------------------------- transient retries

    def run_stage(self, stage: str, fn: Callable, *args, **kwargs):
        """Execute ``fn(*args, **kwargs)`` with the injector probe, the
        stage deadline (if configured), and bounded backoff retry on
        :class:`StageFailure` (including :class:`StageTimeout`).
        ``DeviceFailure`` and :class:`CapacityOverflow` are *not* retried
        here — they need a different recovery (remesh / bigger capacity)
        and propagate to the caller (``run_distributed`` /
        ``run_with_capacity``); :class:`ProcessKilled` propagates always
        (no in-process recovery for a dead process)."""
        stream = self._next_stream(stage)
        attempt = 0
        while True:
            try:
                slow = (self.injector.check(stage)
                        if self.injector is not None else None)
                return self._execute(stage, fn, args, kwargs, slow)
            except StageFailure as e:
                attempt += 1
                if attempt > self.policy.max_retries:
                    raise
                delay = self.policy.delay(attempt, stream=stream)
                action = ("timeout_retry" if isinstance(e, StageTimeout)
                          else "retry")
                log.warning("stage %s failed (attempt %d/%d): %s — retrying"
                            " in %.3gs", stage, attempt,
                            self.policy.max_retries, e, delay)
                self.events.append(StageEvent(stage, attempt, action, str(e)))
                if delay:
                    self._sleep(delay)

    # -------------------------------------------------- speculative backup

    def run_speculative(self, stage: str, fn: Callable, *args,
                        digest_of: Optional[Callable] = None, **kwargs):
        """Execute a (pure) stage with straggler-driven speculative backup:
        the primary runs on a worker thread; if it outlives the monitor's
        cutoff, a backup launches against the same inputs and the first
        *successful* completion wins. The loser is awaited and its output
        digest (``digest_of(out)``) compared before discarding — equality
        confirms the win, disagreement raises
        :class:`SpeculationMismatch`, and a loser that raised is recorded
        but ignored (the winner already proved the stage computable).
        Transient failures of *both* replicas fall back to the
        :class:`StageFailure` retry budget. Without a
        :class:`SpeculationPolicy` this is exactly ``run_stage`` (deadlines
        apply there; the speculative path supersedes them)."""
        if self.speculation is None:
            return self.run_stage(stage, fn, *args, **kwargs)
        stream = self._next_stream(stage)
        attempt = 0
        while True:
            try:
                slow = (self.injector.check(stage)
                        if self.injector is not None else None)
                return self._speculate_once(stage, fn, args, kwargs,
                                            digest_of, slow)
            except StageFailure as e:
                attempt += 1
                if attempt > self.policy.max_retries:
                    raise
                delay = self.policy.delay(attempt, stream=stream)
                log.warning("speculative stage %s failed (attempt %d/%d): "
                            "%s — retrying in %.3gs", stage, attempt,
                            self.policy.max_retries, e, delay)
                self.events.append(StageEvent(stage, attempt, "retry", str(e)))
                if delay:
                    self._sleep(delay)

    def _speculate_once(self, stage: str, fn: Callable, args, kwargs,
                        digest_of: Optional[Callable],
                        slow: Optional[float]):
        spec = self.speculation
        mon = spec.monitor
        step = self._stage_calls.get(stage, 0)
        fn = _on_callers_stream(fn)

        def primary_call():
            # injected slowness applies to the primary only — the backup
            # models a healthy replacement worker
            if slow:
                time.sleep(slow)
            return fn(*args, **kwargs)

        ex = concurrent.futures.ThreadPoolExecutor(
            max_workers=1 + spec.max_backups)
        try:
            t0 = time.monotonic()
            primary = ex.submit(primary_call)
            cutoff = mon.cutoff()
            wait = (max(cutoff, spec.min_wait) if cutoff is not None
                    else None)
            try:
                out = primary.result(timeout=wait)
                mon.record(step, time.monotonic() - t0)
                return out
            except concurrent.futures.TimeoutError:
                pass
            except StageFailure:
                raise  # transient primary failure: no backup, just retry
            self.events.append(StageEvent(
                stage, 0, "speculate",
                f"primary exceeded cutoff {wait:.3g}s — backup launched"))
            log.warning("stage %s straggling past %.3gs — launching "
                        "speculative backup", stage, wait)
            backup = ex.submit(fn, *args, **kwargs)
            names = {primary: "primary", backup: "backup"}
            pending, winner = {primary, backup}, None
            while pending and winner is None:
                done, pending = concurrent.futures.wait(
                    pending,
                    return_when=concurrent.futures.FIRST_COMPLETED)
                for f in done:
                    if f.exception() is None:
                        winner = f
                        break
            if winner is None:
                raise primary.exception()
            out = winner.result()
            mon.record(step, time.monotonic() - t0)
            loser = backup if winner is primary else primary
            try:
                loser_out = loser.result()   # confirm before discarding
            except Exception as e:
                self.events.append(StageEvent(
                    stage, 0, "speculation_loser_failed",
                    f"{names[loser]} raised {type(e).__name__}: {e}"))
            else:
                if digest_of is not None:
                    d_w, d_l = digest_of(out), digest_of(loser_out)
                    if d_w != d_l:
                        raise SpeculationMismatch(stage, d_w, d_l)
                self.events.append(StageEvent(
                    stage, 0, "speculation_confirmed",
                    f"{names[winner]} won; loser output "
                    + ("digest-equal" if digest_of is not None
                       else "discarded unchecked")))
            return out
        finally:
            ex.shutdown(wait=False)

    # -------------------------------------------------- overflow escalation

    def run_with_capacity(self, stage: str, fn: Callable, capacity: int,
                          max_doublings: int = 8):
        """Run ``fn(capacity)`` (through the stage retry machinery),
        doubling ``capacity`` on :class:`CapacityOverflow` — the degrade
        policy that converges instead of dropping elements. When the
        overflow reports its true requirement, jump straight there."""
        for _ in range(max_doublings + 1):
            try:
                return self.run_stage(stage, fn, capacity)
            except CapacityOverflow as e:
                new_cap = max(capacity * 2, e.required or 0)
                log.warning("stage %s overflowed capacity %d — retrying at "
                            "%d", stage, capacity, new_cap)
                self.events.append(StageEvent(
                    stage, 0, "capacity_double",
                    f"capacity {capacity} -> {new_cap}"))
                capacity = new_cap
        raise CapacityOverflow(
            f"stage {stage} still overflowing after {max_doublings} "
            f"doublings", capacity)

    # -------------------------------------------------- mesh-shrink re-run

    def run_distributed(self, make_mesh: Callable[[int], object],
                        devices: int, run: Callable, *,
                        min_devices: int = 1, max_recoveries: int = 8):
        """Execute ``run(make_mesh(devices))`` — a mesh sort — rebuilding a
        smaller mesh on ``DeviceFailure`` (the ``ElasticSupervisor``
        control flow, minus the checkpoint: a sort's input is its own
        checkpoint, so lost chunks simply re-execute on the survivors). The
        injector's ``exchange`` stage probes each dispatch. For the mesh
        chunked sort, ``make_mesh(p)`` gives ``p`` destinations and ``run``
        calls ``core.distributed.distributed_chunked_sort_lex(keys,
        devices=...)`` on them."""
        recoveries = 0
        while True:
            try:
                if self.injector is not None:
                    self.injector.check("exchange")
                return run(make_mesh(devices))
            except DeviceFailure as e:
                recoveries += 1
                if recoveries > max_recoveries:
                    raise RuntimeError("exceeded max recoveries") from e
                survivors = devices - e.failed_devices
                if survivors < min_devices:
                    raise RuntimeError(
                        f"insufficient surviving devices: {survivors} < "
                        f"min_devices={min_devices}") from e
                log.warning("device failure during exchange: %d -> %d "
                            "devices — re-running on survivors",
                            devices, survivors)
                self.events.append(StageEvent(
                    "exchange", recoveries, "remesh",
                    f"{devices} -> {survivors} devices"))
                devices = survivors
