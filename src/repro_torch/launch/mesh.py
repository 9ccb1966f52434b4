"""Mesh construction — the counterpart of ``repro.launch.mesh``, over the
ranks of the default process group (``parallel.compat.make_mesh``; the
group is set up first where it is not). Functions, never module-level
constants: importing this module touches no process group."""

from __future__ import annotations

import math

import torch.distributed as dist

from ..parallel.compat import make_mesh

__all__ = ["make_production_mesh", "make_elastic_mesh", "make_test_mesh"]


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def make_production_mesh(*, multi_pod: bool = False, device_type="cuda"):
    """16x16 = 256 ranks a pod; ``multi_pod`` adds the 2-pod axis. Raises,
    naming the ranks it needs, when the process group is smaller."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = math.prod(shape)
    if _world() < need:
        raise RuntimeError(f"the production mesh {shape} needs {need} ranks; "
                           f"the process group has {_world()}")
    return make_mesh(shape, axes, device_type)


def make_elastic_mesh(n_devices: int, model_parallel: int = 1,
                      device_type="cuda"):
    """The largest (data, model) mesh of ``n_devices`` ranks, ``model`` the
    largest power-of-two divisor of ``model_parallel`` that divides them —
    what a supervisor rebuilds after a failure."""
    model = model_parallel
    while model > 1 and n_devices % model:
        model //= 2
    return make_mesh((n_devices // model, model), ("data", "model"),
                     device_type)


def make_test_mesh(device_type="cuda"):
    """Whatever the process group has: (n/2, 2) from 4 ranks, else
    (n, 1)."""
    n = _world()
    if n >= 4:
        return make_mesh((n // 2, 2), ("data", "model"), device_type)
    return make_mesh((n, 1), ("data", "model"), device_type)
