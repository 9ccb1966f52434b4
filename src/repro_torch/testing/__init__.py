"""Conformance kit of the port — the counterpart of ``repro.testing``: the
op-contract registry, the adversarial generators (the reference's, copied)
and the execution-mode axis behind ``tests/test_torch_conformance.py`` and
``chip_smoke.py``'s phase 10.

Each op of ``kernels.ops`` carries a NumPy oracle and a canonical
adversarial input set, and runs under every execution mode the host
offers — the plain versions on the CPU, and on a card the hand-written
kernels eagerly and captured in a CUDA graph — bit-identical across all of
them.
"""

from .contracts import (CONTRACTS, Case, ConformanceRun, OpContract,
                        assert_conforms, iter_matrix, run_case)
from .generators import (ADVERSARIAL, applicable, check_mode, default_n,
                         fill_elements, make_words, sorted_run_sizes)
from .modes import ExecutionMode, available_modes, provenance

__all__ = [
    "CONTRACTS", "Case", "ConformanceRun", "OpContract", "assert_conforms",
    "iter_matrix", "run_case",
    "ADVERSARIAL", "applicable", "check_mode", "default_n", "fill_elements",
    "make_words", "sorted_run_sizes",
    "ExecutionMode", "available_modes", "provenance",
]
