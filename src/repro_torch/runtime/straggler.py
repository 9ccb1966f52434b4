"""Straggler mitigation (the counterpart of ``repro.runtime.straggler``,
plain Python): per-step timing monitor with EWMA baseline and
z-score outlier flagging, plus a hook for backup-work dispatch.

At pod scale a straggling host shows up as a slow collective; the monitor
runs on the coordinator and flags steps whose duration deviates from the
EWMA by ``threshold`` sigma. The ``on_straggler`` hook is where a deployment
triggers its mitigation (reshard, evict, or dispatch a backup replica —
what MapReduce called speculative execution)."""

from __future__ import annotations

import logging
import math
from typing import Callable, Optional

__all__ = ["StragglerMonitor"]

log = logging.getLogger("repro_torch.runtime")


class StragglerMonitor:
    """``rebaseline_after``: flagged steps never feed the EWMA, so after a
    *durable* regime shift (e.g. the job migrated to slower hardware) the
    frozen baseline would flag every subsequent step forever. After this many
    *consecutive* flags the monitor accepts the new regime: the baseline is
    rebuilt from the flagged durations themselves and flagging resumes
    against it. A genuine one-off straggler resets the streak on the next
    healthy step and never triggers a re-baseline."""

    def __init__(self, alpha: float = 0.1, threshold: float = 3.0,
                 warmup: int = 5, min_ratio: float = 1.5,
                 rebaseline_after: int = 8,
                 on_straggler: Optional[Callable] = None):
        self.alpha = alpha
        self.threshold = threshold
        self.warmup = warmup
        # relative floor: jitter within min_ratio x mean is never a straggler,
        # even when the variance estimate has collapsed on a very steady run
        self.min_ratio = min_ratio
        self.rebaseline_after = rebaseline_after
        self.on_straggler = on_straggler
        self.mean = 0.0
        self.var = 0.0
        self.count = 0
        self.flagged: list[tuple[int, float]] = []
        self.rebaselines: list[int] = []   # steps at which the regime shifted
        self._streak: list[float] = []     # durations of the current flag run

    def _rebaseline(self, step: int):
        """Adopt the flagged streak as the new baseline (Welford over the
        streak, count pinned past warmup so flagging resumes immediately)."""
        self.mean = 0.0
        self.var = 0.0
        for i, d in enumerate(self._streak, start=1):
            delta = d - self.mean
            self.mean += delta / i
            self.var += delta * (d - self.mean)
        self.count = max(self.warmup, len(self._streak))
        self._streak = []
        self.rebaselines.append(step)
        log.warning("straggler monitor re-baselined at step %s: "
                    "%d consecutive flags, new mean %.4g",
                    step, self.rebaseline_after, self.mean)

    def cutoff(self) -> Optional[float]:
        """Speculation cutoff in seconds — how long a task may run before a
        backup is worth launching: ``None`` during warmup (no baseline to
        judge against yet), else ``mean * min_ratio``, the same relative
        floor :meth:`record` applies before flagging. Consumed by
        ``runtime.sortfault.SortSupervisor.run_speculative``."""
        if self.count < self.warmup or self.mean <= 0:
            return None
        return self.mean * self.min_ratio

    def record(self, step: int, duration: float) -> bool:
        """Returns True if this step is flagged as a straggler."""
        self.count += 1
        if self.count <= self.warmup:
            # warmup: estimate baseline
            d = duration - self.mean
            self.mean += d / self.count
            self.var += d * (duration - self.mean)
            return False
        std = math.sqrt(max(self.var / max(self.count - 1, 1), 1e-12))
        z = (duration - self.mean) / std
        is_straggler = z > self.threshold and duration > self.mean * self.min_ratio
        if is_straggler:
            self.flagged.append((step, duration))
            self._streak.append(duration)
            if self.on_straggler:
                self.on_straggler(step, duration, z)
            if len(self._streak) >= self.rebaseline_after:
                self._rebaseline(step)
        else:
            # update EWMA baseline with healthy steps only
            self._streak = []
            d = duration - self.mean
            self.mean += self.alpha * d
            self.var = (1 - self.alpha) * (self.var + self.alpha * d * d)
        return is_straggler
