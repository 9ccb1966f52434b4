"""Runtime concerns of the port, testable on one host — the counterpart of
``repro.runtime``: elastic failure recovery, straggler detection, simulated
failure injection, the sort pipeline's stage-level fault supervision
(``sortfault``), the seeded chaos soak of the mesh chunked sort
(``chaos``), and the port's own spans and host-sync counter (``trace``)."""

from .failure import (CapacityOverflow, DeviceFailure, ElasticSupervisor,
                      FailureInjector)
from .straggler import StragglerMonitor

__all__ = ["DeviceFailure", "CapacityOverflow", "ElasticSupervisor",
           "FailureInjector", "StragglerMonitor",
           "StageFailure", "StageTimeout", "ProcessKilled",
           "SpeculationMismatch", "StageFailureInjector", "RetryPolicy",
           "StageEvent", "SpeculationPolicy", "SortSupervisor",
           "ChaosPlan", "make_plan", "apply_damages", "chaos_soak",
           "SoakReport"]

# ``sortfault``'s supervisor drives the device pipeline; expose it lazily
# (PEP 562, the reference's idiom) so ``kernels``/``core`` can import the
# failure types above without re-entering this package mid-initialisation.
# ``chaos`` imports the pipeline and the device stack, so it stays lazy too.
_LAZY = {"StageFailure": "sortfault", "StageTimeout": "sortfault",
         "ProcessKilled": "sortfault", "SpeculationMismatch": "sortfault",
         "StageFailureInjector": "sortfault", "RetryPolicy": "sortfault",
         "StageEvent": "sortfault", "SpeculationPolicy": "sortfault",
         "SortSupervisor": "sortfault",
         "ChaosPlan": "chaos", "make_plan": "chaos",
         "apply_damages": "chaos", "chaos_soak": "chaos",
         "SoakReport": "chaos"}


def __getattr__(name):
    if name in _LAZY:
        from importlib import import_module
        return getattr(import_module(f".{_LAZY[name]}", __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
