"""Elastic failure recovery — the counterpart of ``repro.runtime.failure``
(plain Python; the port keeps its own copy).

On real pods a node failure surfaces as a collective timeout / RPC error;
here it is modelled by ``DeviceFailure``. The supervisor wraps the training
loop: on failure it (1) drops to the surviving device count, (2) rebuilds the
mesh via the user-provided factory, (3) restores the latest checkpoint onto
the survivors (``checkpoint/manager.py``'s restore onto a device), and (4)
continues from the restored step. This is the same control flow a 1000-node
deployment needs; only the failure *detector* differs.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Callable

__all__ = ["DeviceFailure", "CapacityOverflow", "FailureInjector",
           "ElasticSupervisor"]

log = logging.getLogger("repro_torch.runtime")


class DeviceFailure(RuntimeError):
    """Raised when a device/host is lost (simulated on CPU)."""

    def __init__(self, msg: str, failed_devices: int = 1):
        super().__init__(msg)
        self.failed_devices = failed_devices


class CapacityOverflow(ValueError):
    """A statically sized buffer (bucket tensor, exchange capacity) received
    more elements than it holds. Carries enough structure for a supervisor
    to escalate into a capacity-doubling retry instead of dropping data
    (``runtime/sortfault.py``); subclasses ``ValueError`` so pre-existing
    ``except ValueError`` overflow handling keeps working."""

    def __init__(self, msg: str, capacity: int, required: int | None = None,
                 dropped: int | None = None):
        super().__init__(msg)
        self.capacity = capacity
        self.required = required
        self.dropped = dropped


class FailureInjector:
    """Deterministic failure schedule for tests: fail at given steps."""

    def __init__(self, fail_at_steps=(), failed_devices: int = 1):
        self.fail_at = set(fail_at_steps)
        self.failed_devices = failed_devices
        self._fired = set()

    def check(self, step: int):
        if step in self.fail_at and step not in self._fired:
            self._fired.add(step)
            raise DeviceFailure(f"injected failure at step {step}", self.failed_devices)


@dataclasses.dataclass
class RecoveryEvent:
    step: int
    devices_before: int
    devices_after: int


class ElasticSupervisor:
    """Run a step loop with checkpoint/restart + elastic mesh shrink.

    ``run_segment(state, start_step, devices) -> (state, next_step)`` executes
    steps until completion or raises DeviceFailure. ``remesh(devices)`` tells
    the caller to rebuild mesh/shardings/jit for the new world size and
    restore ``state`` from the checkpoint manager.

    ``restartable=True`` models single-host (or respawning-scheduler)
    recovery: a failed device is replaced by the restarted process, so the
    world size never shrinks — recovery is restore-from-checkpoint only.
    The default ``False`` is true elastic semantics: survivors only, and
    dropping below ``min_devices`` raises instead of pretending lost
    hardware still exists.
    """

    def __init__(self, ckpt_manager, initial_devices: int,
                 min_devices: int = 1, max_recoveries: int = 8,
                 restartable: bool = False):
        self.ckpt = ckpt_manager
        self.devices = initial_devices
        self.min_devices = min_devices
        self.max_recoveries = max_recoveries
        self.restartable = restartable
        self.events: list[RecoveryEvent] = []

    def run(self, run_segment: Callable, remesh: Callable, state, start_step: int = 0):
        step = start_step
        recoveries = 0
        while True:
            try:
                return run_segment(state, step, self.devices)
            except DeviceFailure as e:
                recoveries += 1
                if recoveries > self.max_recoveries:
                    raise RuntimeError("exceeded max recoveries") from e
                before = self.devices
                if self.restartable:
                    # the scheduler respawns the lost device: same world
                    # size, recovery is restore-from-checkpoint only
                    log.warning("device failure at step %s: restarting on "
                                "%s devices", step, self.devices)
                else:
                    survivors = self.devices - e.failed_devices
                    if survivors < self.min_devices:
                        # pretending min_devices still exist would run work
                        # on hardware that is gone — fail loudly instead of
                        # clamping
                        raise RuntimeError(
                            f"insufficient surviving devices: {survivors} < "
                            f"min_devices={self.min_devices}") from e
                    self.devices = survivors
                    log.warning("device failure at step %s: %s -> %s devices",
                                step, before, self.devices)
                self.ckpt.wait()  # let any in-flight snapshot land
                restored = remesh(self.devices)
                if restored is None:
                    raise RuntimeError("no checkpoint to recover from") from e
                step, state = restored
                self.events.append(RecoveryEvent(step, before, self.devices))
