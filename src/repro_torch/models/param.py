"""Parameter construction with its sharding metadata — the counterpart of
``repro.models.param``.

A :class:`Builder` draws every parameter from one explicit
``torch.Generator`` on one device, with the reference's init kinds:
'normal' (scaled by ``fan_in ** -0.5`` unless ``scale`` is given, the
fan-in being ``shape[-2]``, or ``shape[-1]`` for a vector), 'zeros', 'ones'
and 'ssm_a' (Mamba's ``A_log``: the log of Uniform[1, 16]). Draws are made
in float32 and cast to the parameter dtype. On the ``meta`` device it
allocates and draws nothing — the reference's ``abstract=True`` — which is
how weights carried over from the reference are loaded without a random
init first (``interop.lm_from_reference``).

Every parameter is trainable (``requires_grad``); the serving paths run
under ``torch.inference_mode`` or ``torch.no_grad``, so they build no
autograd graph.

Each parameter is made with its logical axes (``Builder.param(shape,
axes, ...)``, one name or ``None`` a dimension), recorded on the
``nn.Parameter`` as ``axes`` and by the :class:`ParamModule` that holds
it, so the weights and their plan cannot drift apart. :func:`finalize`
reads them back as ``{name: axes}`` named as the ``state_dict`` — the
reference's axes tree with each stack's leading ``"layers"`` dropped,
since the port holds one module a layer; :func:`tree_specs` turns them
into specs for a mesh and :func:`shard_lm` places every parameter on it as
a ``DTensor``.

The port's draws are not JAX's: the same seed gives other weights in the
two packages. Tests that compare them carry the reference's weights across.
"""

from __future__ import annotations

import torch
from torch import nn

__all__ = ["Builder", "ParamModule", "finalize", "tree_specs", "shard_lm",
           "distribute_tree"]

_INITS = ("normal", "zeros", "ones", "ssm_a")


class Builder:
    """Creates parameter tensors on ``device`` in ``dtype`` from
    ``generator`` (a ``torch.Generator`` on that device; ``None`` is
    allowed on the ``meta`` device, which draws nothing)."""

    def __init__(self, generator: torch.Generator | None,
                 dtype=torch.float32, device="cpu"):
        self.generator = generator
        self.dtype = dtype
        self.device = torch.device(device)

    @property
    def abstract(self) -> bool:
        return self.device.type == "meta"

    def param(self, shape, axes=None, init: str = "normal",
              scale: float | None = None, dtype=None) -> nn.Parameter:
        """A parameter of ``shape`` with logical ``axes`` (``None``: every
        dimension unnamed, replicated on any mesh); raises when ``axes``
        and ``shape`` differ in length, as the reference does."""
        axes = (None,) * len(shape) if axes is None else tuple(axes)
        if len(axes) != len(shape):
            raise ValueError(f"axes {axes} do not match shape {shape}")
        if init not in _INITS:
            raise ValueError(f"unknown init {init!r}")
        dtype = dtype or self.dtype
        shape = tuple(shape)
        dev, gen = self.device, self.generator
        if self.abstract:
            v = torch.empty(shape, dtype=dtype, device=dev)
        elif init == "normal":
            if scale is None:
                fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
                scale = fan_in ** -0.5
            v = (scale * torch.randn(shape, generator=gen, device=dev)
                 ).to(dtype)
        elif init == "zeros":
            v = torch.zeros(shape, dtype=dtype, device=dev)
        elif init == "ones":
            v = torch.ones(shape, dtype=dtype, device=dev)
        else:                              # ssm_a: log of Uniform[1, 16]
            u = torch.rand(shape, generator=gen, device=dev)
            v = torch.log(1.0 + 15.0 * u).to(dtype)
        p = nn.Parameter(v)
        p.axes = axes
        return p


class ParamModule(nn.Module):
    """An ``nn.Module`` that keeps the logical axes of each parameter
    assigned to it, by attribute name: a Parameter replaced later
    (``load_state_dict(assign=True)``, :func:`shard_lm`, a deep copy) keeps
    its place's axes, where an attribute of the Parameter would be lost."""

    def __setattr__(self, name, value):
        axes = getattr(value, "axes", None)
        if isinstance(value, nn.Parameter) and axes is not None:
            self.__dict__.setdefault("_param_axes", {})[name] = axes
        super().__setattr__(name, value)


def finalize(module: nn.Module) -> dict:
    """``{name: logical axes}`` of every parameter of ``module``, named as
    its ``state_dict``; a parameter of a plain ``nn.Module`` by its own
    ``axes``."""
    out = {}
    for name, p in module.named_parameters():
        owner, _, leaf = name.rpartition(".")
        kept = module.get_submodule(owner).__dict__.get("_param_axes", {})
        out[name] = kept[leaf] if leaf in kept else p.axes
    return out


def _tree_map(fn, axes, *trees):
    """``fn(axes, *leaves)`` over a (nested) dict of axes tuples."""
    return {k: _tree_map(fn, a, *(t[k] for t in trees))
            if isinstance(a, dict) else fn(a, *(t[k] for t in trees))
            for k, a in axes.items()}


def tree_specs(axes, rules, mesh, values=None) -> dict:
    """Specs for ``mesh`` from a (nested) dict of logical axes —
    :func:`finalize`'s ``{name: axes}`` or ``init_cache``'s axes:
    ``rules.mesh_spec`` of each, or with ``values`` (the same structure of
    tensors, or an ``nn.Module``; only shapes are read) the
    divisibility-aware ``rules.shape_spec`` of each leaf's shape."""
    from ..parallel.sharding import mesh_sizes
    if values is None:
        names = tuple(mesh.mesh_dim_names)
        return _tree_map(lambda a: rules.mesh_spec(a, names), axes)
    if isinstance(values, nn.Module):
        values = dict(values.named_parameters())
    sizes = mesh_sizes(mesh)
    return _tree_map(lambda a, v: rules.shape_spec(a, v.shape, sizes), axes,
                     values)


def distribute_tree(values, axes, rules, mesh, src_data_rank: int | None = 0):
    """A (nested) dict of tensors — a decode cache with ``init_cache``'s
    axes — as ``DTensor``s on ``mesh``, each placed by its
    divisibility-aware spec (``src_data_rank`` as in :func:`shard_lm`)."""
    from torch.distributed.tensor import distribute_tensor

    from ..parallel.sharding import placements
    specs = tree_specs(axes, rules, mesh, values)
    return _tree_map(
        lambda s, v: distribute_tensor(v, mesh, placements(s, mesh),
                                       src_data_rank=src_data_rank),
        specs, values)


def shard_lm(lm: nn.Module, rules, mesh, src_data_rank: int | None = 0):
    """Every parameter of ``lm`` replaced, in place, by a ``DTensor`` on
    ``mesh`` placed by its divisibility-aware spec (``distribute_tensor``;
    its ``axes`` kept). ``src_data_rank`` is ``distribute_tensor``'s: the
    rank whose weights are scattered, or ``None`` where every rank holds
    the same weights already (drawn from one seed), so that each takes its
    own shard and nothing crosses between the ranks. Returns ``lm``."""
    from torch.distributed.tensor import distribute_tensor

    from ..parallel.sharding import placements
    specs = tree_specs(finalize(lm), rules, mesh, lm)
    for name, p in list(lm.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        dt = distribute_tensor(p.detach(), mesh,
                               placements(specs[name], mesh),
                               src_data_rank=src_data_rank)
        setattr(lm.get_submodule(owner), leaf,
                nn.Parameter(dt, requires_grad=p.requires_grad))
    return lm
