"""Failure types of the port. Only ``CapacityOverflow`` so far: the
supervisor, the failure injector and the elastic loop of
``repro.runtime.failure`` wait for ROADMAP A10."""

from __future__ import annotations

__all__ = ["CapacityOverflow"]


class CapacityOverflow(ValueError):
    """A statically sized buffer (bucket tensor, exchange capacity) received
    more elements than it holds. Carries enough structure for a supervisor
    to escalate into a capacity-doubling retry instead of dropping data;
    subclasses ``ValueError`` so ``except ValueError`` overflow handling
    keeps working. The same fields as ``repro.runtime.CapacityOverflow``."""

    def __init__(self, msg: str, capacity: int, required: int | None = None,
                 dropped: int | None = None):
        super().__init__(msg)
        self.capacity = capacity
        self.required = required
        self.dropped = dropped
