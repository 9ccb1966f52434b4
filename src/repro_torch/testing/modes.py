"""The execution-mode axis of the conformance kit — the counterpart of
``repro.testing.modes``.

Every op contract runs under every mode the host offers and the results
must be bit-identical across them. The reference's modes fix the Pallas
lowering (interpreted or native) and the dispatch granularity (eager or
one ``jax.jit`` program). The port's fix three knobs:

  * ``device`` — where the op's tensors live, 'cpu' or 'cuda';
  * ``kernels`` — whether the op launches the hand-written kernels
    (``kernels/csrc``, on a CUDA device) or runs their plain PyTorch
    versions (on the CPU: each wrapper picks by its tensors' device);
  * ``graph`` — whether the op call is captured once into a CUDA graph and
    the graph replayed (the counterpart of the reference's ``jit`` mode:
    the whole call as one launchable program, so any host synchronisation
    or host-side planning inside it must hold under capture).

``available_modes()`` gives ``torch-cpu`` (the plain versions on CPU
tensors) everywhere, and on a card also ``cuda-kernel`` (the kernels,
eager) and ``cuda-graph`` (the kernels, the call captured and replayed).

Per-run provenance (:func:`provenance`) extends
``kernels.ops.execution_provenance`` with the mode's label and knobs, so a
conformance result names what it ran on.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..kernels.ops import execution_provenance

__all__ = ["ExecutionMode", "available_modes", "provenance"]


@dataclass(frozen=True)
class ExecutionMode:
    """One point on the execution-mode axis.

    ``name`` — the stable label stamped into provenance;
    ``device`` — the device type the op's tensors live on;
    ``kernels`` — whether the hand-written kernels run (a CUDA device);
    ``graph`` — whether the call is captured into a CUDA graph and
    replayed.
    """

    name: str
    device: str
    kernels: bool
    graph: bool


TORCH_CPU = ExecutionMode("torch-cpu", "cpu", kernels=False, graph=False)
CUDA_KERNEL = ExecutionMode("cuda-kernel", "cuda", kernels=True, graph=False)
CUDA_GRAPH = ExecutionMode("cuda-graph", "cuda", kernels=True, graph=True)


def available_modes() -> tuple[ExecutionMode, ...]:
    """The execution modes this host can run, most-debuggable first:
    ``torch-cpu``, and ``cuda-kernel`` and ``cuda-graph`` where there is a
    card."""
    if torch.cuda.is_available():
        return (TORCH_CPU, CUDA_KERNEL, CUDA_GRAPH)
    return (TORCH_CPU,)


def provenance(mode: ExecutionMode) -> dict:
    """Backend/device/torch-version provenance for one conformance run."""
    return dict(execution_provenance(mode.device), mode=mode.name,
                graph=mode.graph)
