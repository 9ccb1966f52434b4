"""Carrying state between the reference package and the port.

The sort has no weights: what crosses between the two packages is data —
packed keys ``(n, lanes)``, a bucket tensor ``(num_buckets, capacity,
lanes)`` and its counts — as numpy arrays on the reference's side and torch
tensors on the port's. ``uint32`` arrays become ``torch.uint32`` tensors
with the same bits (moved as int32 views, since torch's uint32 support is
thin) and come back as ``numpy.uint32``. A sorted run crosses as its fields:
:func:`run_to_device` builds the port's ``pipeline.SortedRun`` from the
reference's ``SortedRun`` fields (``lengths``, ``keys``, ``packed``), and
:func:`run_to_numpy` gives them back.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["resolve_device", "to_device", "to_numpy", "run_to_device",
           "run_to_numpy", "lm_from_reference"]


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises if it names CUDA and no card
    is present — the port never drops to the CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the kernels' plain versions")
    return dev


def to_device(x, device="cuda"):
    """A numpy array or torch tensor — or a tuple or list of them — as
    torch tensors on ``device``, bits unchanged."""
    if isinstance(x, (tuple, list)):
        return type(x)(to_device(a, device) for a in x)
    dev = resolve_device(device)
    if isinstance(x, torch.Tensor):
        t = x
    else:
        a = np.ascontiguousarray(x).reshape(np.shape(x))  # keeps 0-d
        if not a.flags.writeable:     # torch does not take read-only arrays
            a = a.copy()
        t = torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)
        if a.dtype == np.uint32:
            t = t.view(torch.uint32)
    if t.dtype == torch.uint32:
        return t.view(torch.int32).to(dev).view(torch.uint32)
    return t.to(dev)


def to_numpy(x):
    """A torch tensor — or a tuple or list of them — as numpy arrays on the
    host, bits unchanged (``torch.uint32`` becomes ``numpy.uint32``)."""
    if isinstance(x, (tuple, list)):
        return type(x)(to_numpy(t) for t in x)
    if x.dtype == torch.uint32:
        return x.view(torch.int32).cpu().numpy().view(np.uint32)
    return x.cpu().numpy()


def run_to_device(lengths, keys, packed=None, device="cuda"):
    """The port's ``pipeline.SortedRun`` on ``device`` from a sorted run's
    fields as the reference holds them (numpy or anything ``np.asarray``
    takes): ``lengths`` (m,) int32, ``keys`` (m, lanes) uint32 and the
    optional packed rank-key lanes."""
    from .pipeline.ingest import SortedRun    # the pipeline imports interop
    return SortedRun(
        lengths=to_device(np.asarray(lengths, np.int32), device),
        keys=to_device(np.asarray(keys, np.uint32), device),
        packed=None if packed is None else tuple(
            to_device(np.asarray(p), device) for p in packed))


def run_to_numpy(run):
    """A port ``SortedRun``'s fields as numpy arrays, the reference's
    ``SortedRun`` fields: ``(lengths, keys, packed_or_None)``."""
    packed = None if run.packed is None else tuple(to_numpy(run.packed))
    return to_numpy(run.lengths), to_numpy(run.keys), packed


# the reference's parameter stacks with a leading layer axis
# (``repro/models/model.py:48-57``)
_STACKS = ("first", "blocks")


def _weight(a) -> torch.Tensor:
    """A numpy weight as a CPU tensor, bfloat16 leaves (numpy's
    ``ml_dtypes.bfloat16``, which torch cannot take) through their bits."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _flatten(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def lm_from_reference(cfg, params, device="cuda"):
    """The port's ``models.LM`` of ``cfg`` on ``device`` holding the
    reference's weights ``params`` (``repro.models.init_lm``'s nested dict,
    each leaf as a numpy array; bfloat16 leaves are taken). The stacked
    'first' and 'blocks' leaves are split along their layer axis into the
    LM's per-layer blocks; a tied-embeddings config has no 'head'. Every
    weight keeps its dtype; a missing or extra leaf raises."""
    from .models.model import init_lm       # the models import interop
    dev = resolve_device(device)
    state = {}
    for path, leaf in _flatten(params):
        top, _, rest = path.partition(".")
        w = _weight(leaf)
        if top in _STACKS:
            for i in range(w.shape[0]):
                state[f"{top}.{i}.{rest}"] = w[i].to(dev)
        else:
            state[path] = w.to(dev)
    lm = init_lm(cfg, device="meta")
    # assign: the LM takes these tensors (device, dtype) as they are
    lm.load_state_dict(state, strict=True, assign=True)
    return lm
