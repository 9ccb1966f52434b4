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

``bfloat16`` crosses by its bits too. numpy has no bfloat16 of its own: the
reference's arrays carry ``ml_dtypes.bfloat16``, and its ``.npy`` files
hold raw 2-byte records that ``np.load`` reads as ``|V2``. The port gives
a bf16 tensor to numpy as such a ``V2`` array (:func:`to_numpy`) and takes
either kind back (:func:`to_device`), so no bit changes either way.

The models' weights cross as the reference's nested dict with the layer
axis of the 'first' and 'blocks' stacks leading (:func:`lm_from_reference`,
:func:`lm_to_reference`), and AdamW's state as the reference's ``{"m",
"v", "count"}`` over that layout (:func:`opt_state_from_reference`,
:func:`opt_state_to_reference`) — the layout of a training snapshot, so a
snapshot either package writes restores in the other.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["resolve_device", "to_device", "to_numpy", "run_to_device",
           "run_to_numpy", "is_bf16", "lm_from_reference", "lm_to_reference",
           "named_from_reference", "named_to_reference",
           "opt_state_from_reference", "opt_state_to_reference"]

BF16_RECORD = np.dtype("V2")


def is_bf16(a: np.ndarray) -> bool:
    """Whether numpy array ``a`` holds bfloat16: ``ml_dtypes.bfloat16``, or
    the raw 2-byte records of a bf16 ``.npy`` file (``|V2``)."""
    return a.dtype.name == "bfloat16" or (
        a.dtype.kind == "V" and a.dtype.itemsize == 2
        and a.dtype.names is None)


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
        if a.dtype == np.uint32:
            t = torch.from_numpy(a.view(np.int32)).view(torch.uint32)
        elif is_bf16(a):
            t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(a)
    if t.dtype == torch.uint32:
        return t.view(torch.int32).to(dev).view(torch.uint32)
    return t.to(dev)


def to_numpy(x):
    """A torch tensor — or a tuple or list of them — as numpy arrays on the
    host, bits unchanged (``torch.uint32`` becomes ``numpy.uint32``,
    ``torch.bfloat16`` 2-byte ``V2`` records); a ``DTensor`` as its global
    array (every rank must call it: its shards are gathered)."""
    if isinstance(x, (tuple, list)):
        return type(x)(to_numpy(t) for t in x)
    x = x.detach()
    if hasattr(x, "full_tensor"):             # a DTensor: its global array
        x = x.full_tensor()
    if x.dtype == torch.uint32:
        return x.view(torch.int32).cpu().numpy().view(np.uint32)
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).cpu().numpy().view(BF16_RECORD)
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
    """A tensor as it is, or a numpy array (bfloat16 through its bits)
    copied into a CPU tensor."""
    if isinstance(a, torch.Tensor):
        return a.detach()
    return to_device(np.array(a), "cpu")


def _flatten(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def named_from_reference(tree) -> dict:
    """``{name: tensor}`` named as the port's ``state_dict`` from a tree in
    the reference's layout (tensor leaves stay on their device, numpy ones
    come to the CPU): the stacked 'first' and 'blocks' leaves split along
    their layer axis (``blocks.3.attn.wq``), the rest by their path
    (``final_norm.w``)."""
    named = {}
    for path, leaf in _flatten(tree):
        top, _, rest = path.partition(".")
        w = _weight(leaf)
        if top in _STACKS:
            for i in range(w.shape[0]):
                named[f"{top}.{i}.{rest}"] = w[i]
        else:
            named[path] = w
    return named


def named_to_reference(named) -> dict:
    """The reference's nested dict of numpy arrays from ``{name: tensor}``
    named as the port's ``state_dict``: each stack's layers stacked again
    along a leading axis, every leaf copied to the host, bfloat16 through
    its bits."""
    groups = {}             # path -> [(layer, tensor)], layer None unstacked
    for name, t in named.items():
        top, _, rest = name.partition(".")
        if top in _STACKS:
            i, _, rest = rest.partition(".")
            groups.setdefault(f"{top}.{rest}", []).append((int(i), t))
        else:
            groups[name] = [(None, t)]
    tree = {}
    for path, layers in groups.items():
        *parents, last = path.split(".")
        node = tree
        for k in parents:
            node = node.setdefault(k, {})
        stacked = layers[0][0] is not None
        if stacked:
            layers.sort(key=lambda il: il[0])
        arrs = [to_numpy(t) for _, t in layers]
        node[last] = np.stack(arrs) if stacked else np.array(arrs[0])
    return tree


def lm_from_reference(cfg, params, device="cuda"):
    """The port's ``models.LM`` of ``cfg`` on ``device`` holding the
    reference's weights ``params`` (``repro.models.init_lm``'s nested dict,
    each leaf a numpy array — bfloat16 leaves are taken — or a tensor). The
    stacked 'first' and 'blocks' leaves are split along their layer axis
    into the LM's per-layer blocks (Mamba2 layers' ``ln`` and ``mixer`` as
    MLA's and GQA's ``attn`` leaves); the hybrid's 'shared' block is one
    block, not a stack. A tied-embeddings config has no 'head'. Every
    weight keeps its dtype; a missing or extra leaf raises."""
    from .models.model import init_lm       # the models import interop
    dev = resolve_device(device)
    state = {k: v.to(dev) for k, v in named_from_reference(params).items()}
    lm = init_lm(cfg, device="meta")
    # assign: the LM takes these tensors (device, dtype) as they are
    lm.load_state_dict(state, strict=True, assign=True)
    return lm


def lm_to_reference(lm) -> dict:
    """The weights of port ``LM`` ``lm`` as the reference's nested dict of
    numpy arrays (:func:`lm_from_reference`'s reverse): each stack's
    layers stacked again along a leading axis, every leaf copied to the
    host with its dtype, bfloat16 as ``V2`` records of its bits."""
    return named_to_reference(lm.state_dict())


def opt_state_to_reference(opt) -> dict:
    """The port's AdamW state (``optim.init_opt_state``: ``{"m", "v"}`` of
    tensors named as the LM's parameters, and ``count``) as the reference's:
    the moments in :func:`lm_to_reference`'s layout, ``count`` a 0-d numpy
    int32 array."""
    return {"m": named_to_reference(opt["m"]),
            "v": named_to_reference(opt["v"]),
            "count": to_numpy(opt["count"])}


def opt_state_from_reference(opt, device="cuda") -> dict:
    """The reference's AdamW state (``repro.optim.init_opt_state``'s tree,
    numpy or tensor leaves) as the port's, on ``device``: the moments named
    as the LM's parameters, each with its dtype."""
    dev = resolve_device(device)

    def named(tree):
        return {k: v.to(dev) for k, v in named_from_reference(tree).items()}
    return {"m": named(opt["m"]), "v": named(opt["v"]),
            "count": _weight(opt["count"]).to(dev, torch.int32)}
