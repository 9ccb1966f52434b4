"""Logical-axis sharding rules — the counterpart of
``repro.parallel.sharding``, rendered as DTensor placements.

Every parameter and activation dimension of the model stack has a
*logical* axis name; a :class:`Rules` table maps logical names to mesh
axes, so a parallelism plan (pure DP, FSDP x TP, EP, a sequence-sharded KV
cache) is a table edit, not a model edit.

A spec is a plain tuple with one entry a tensor dimension: ``None``
(replicated), a mesh axis name, or a tuple of names — entry for entry the
reference's ``PartitionSpec``. :func:`placements` renders it for a
``DeviceMesh`` with named dimensions: ``Shard(d)`` on every mesh dimension
that the spec names for tensor dimension ``d``, ``Replicate()`` on the
others. A dimension split over several mesh axes is split over them in the
mesh's order, the major one first, as a ``NamedSharding`` does.

Under an active mesh (``compat.set_mesh``) :func:`constrain` redistributes
a ``DTensor`` to its divisibility-aware spec — the reference's
``with_sharding_constraint``, with the collectives that GSPMD would derive
taken by ``DTensor.redistribute``; a partial sum (a vocab-sharded
embedding's output) is reduced there. Outside a mesh, or on a plain tensor,
it is the identity, as the reference's is when no mesh is active.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Mapping

from .compat import get_mesh

__all__ = ["Rules", "DEFAULT_RULES", "NamedSharding", "constrain",
           "constrain_as", "constrain_core", "spec_for", "placements",
           "mesh_sizes", "mesh_inputs", "whole", "replicated_like"]


# FSDP (params sharded over `data`) x TP (`model`) x DP over pods — the
# reference's baseline plan
DEFAULT_RULES: Mapping[str, object] = {
    # activations
    "batch": ("pod", "data"),
    "seq": None,
    "res_seq": None,          # residual-region sequence axis: "model" for
                              # Megatron-style sequence parallelism
    "act_embed": None,
    "act_heads": "model",
    "act_mlp": "model",
    "act_expert": "model",
    "act_vocab": "model",
    # parameters
    "layers": None,
    "embed": "data",          # FSDP: gather per layer
    "heads": "model",
    "kv_heads": "model",
    "mlp": "model",
    "vocab": "model",
    "expert": "model",        # expert parallelism
    "expert_mlp": None,
    "q_lora": None,
    "kv_lora": None,
    "state": None,
    "conv": None,
    # kv / ssm caches
    "cache_batch": ("data",),
    "cache_seq": None,
    "cache_kv_heads": "model",
    # the port's: the attention and SSD cores batch-parallel over every
    # axis, their heads whole (:func:`constrain_core`)
    "core_batch": ("pod", "data", "model"),
}


def _entry(kept):
    """A spec entry from the mesh axes kept for one dimension: ``None``,
    the bare name, or the tuple (a 1-tuple is the bare name, as newer
    ``PartitionSpec``s normalise it)."""
    if not kept:
        return None
    return kept[0] if len(kept) == 1 else tuple(kept)


@dataclasses.dataclass(frozen=True)
class Rules:
    """Immutable logical -> mesh axis mapping with the spec helpers."""

    table: Mapping[str, object] = dataclasses.field(
        default_factory=lambda: dict(DEFAULT_RULES))

    def override(self, **kw) -> "Rules":
        t = dict(self.table)
        t.update(kw)
        return Rules(t)

    def spec(self, axes) -> tuple:
        """The spec of a tuple of logical axis names (None: replicated),
        the table's entries as they are."""
        return tuple(None if a is None else self.table.get(a) for a in axes)

    def mesh_spec(self, axes, mesh_axis_names) -> tuple:
        """:meth:`spec` without the mesh axes absent from the mesh, so the
        same rules serve a one-device test mesh and a pod."""
        entries = []
        for a in axes:
            m = None if a is None else self.table.get(a)
            if m is None:
                entries.append(None)
            elif isinstance(m, (tuple, list)):
                entries.append(_entry([x for x in m
                                       if x in mesh_axis_names]))
            else:
                entries.append(m if m in mesh_axis_names else None)
        return tuple(entries)

    def shape_spec(self, axes, shape, mesh_axis_sizes) -> tuple:
        """Divisibility-aware spec: for each dimension the longest prefix
        of its mapped mesh axes whose sizes' product divides it (8 KV heads
        cannot shard over a 16-way ``model`` axis and stay replicated). A
        mesh axis is used at most once a spec, the first logical axis
        taking it."""
        entries = []
        used: set = set()
        for a, dim in zip(axes, shape):
            m = None if a is None else self.table.get(a)
            if m is None:
                entries.append(None)
                continue
            cand = (m,) if isinstance(m, str) else tuple(m)
            cand = [x for x in cand if x in mesh_axis_sizes and x not in used]
            kept, prod = [], 1
            for x in cand:
                if dim % (prod * mesh_axis_sizes[x]) == 0:
                    kept.append(x)
                    prod *= mesh_axis_sizes[x]
                else:
                    break
            used.update(kept)
            entries.append(_entry(kept))
        return tuple(entries)


def mesh_sizes(mesh) -> dict:
    """``{name: size}`` of a ``DeviceMesh``'s named dimensions."""
    return {n: mesh.size(i) for i, n in enumerate(mesh.mesh_dim_names)}


def spec_for(rules: Rules, axes, mesh=None) -> tuple:
    """:meth:`Rules.mesh_spec` against ``mesh``'s dimension names, or the
    active mesh's (none: every entry ``None``)."""
    mesh = get_mesh() if mesh is None else mesh
    names = () if mesh is None else tuple(mesh.mesh_dim_names)
    return rules.mesh_spec(axes, names)


def placements(spec, mesh) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh``, one a mesh
    dimension. A tensor dimension split over several mesh axes must name
    them in the mesh's order (major first); DTensor's nested ``Shard``s
    split in that order, so another order would place other rows."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} is not in the mesh's "
                             f"order {names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh — ``jax.sharding.NamedSharding`` — as a restore's
    ``shardings`` leaf (``checkpoint.restore``)."""

    mesh: object
    spec: tuple

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


def constrain(x, rules: Rules, *axes):
    """Place ``x`` by the divisibility-aware spec of ``axes`` on the
    active mesh (``DTensor.redistribute``; a partial sum is reduced). The
    identity outside a mesh or for a plain tensor."""
    return constrain_as(x, rules, axes, x.shape)


def constrain_as(x, rules: Rules, axes, shape):
    """:func:`constrain` by the divisibility-aware spec of ``axes`` at
    ``shape`` — the shape ``x`` is about to be viewed as, one entry a
    dimension of ``x``: a fused ``(heads, k)`` axis is placed as ``heads``
    divides, so that splitting it again never leaves a shard uneven."""
    mesh = get_mesh()
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    spec = rules.shape_spec(axes, shape, mesh_sizes(mesh))
    return x.redistribute(mesh, placements(spec, mesh))


_INPUTS = contextvars.ContextVar("mesh_inputs", default=False)


def constrain_core(x, rules: Rules):
    """``x`` placed for an attention or SSD core: its leading batch axis
    split over every mesh axis that divides it (``core_batch``), the rest
    whole. The cores' batched products flatten the batch axis with the
    head axis; torch 2.11's DTensor cannot flatten two split axes, so the
    heads, split on ``model`` around the core, are whole inside it. The
    identity outside a mesh."""
    return constrain(x, rules, "core_batch", *([None] * (x.dim() - 1)))


@contextlib.contextmanager
def mesh_inputs():
    """The context, or decorator, of the model's entry points: under an
    active mesh, plain tensors (tokens, positions, masks, rope tables,
    iotas, the optimizer's step count) stand beside ``DTensor``s as
    replicated (``implicit_replication``); outside one it does nothing.
    Nested entries (a train step around a loss around a forward) enter it
    once: ``implicit_replication`` switches off on leaving, whatever was on
    before."""
    if get_mesh() is None or _INPUTS.get():
        yield
        return
    from torch.distributed.tensor.experimental import implicit_replication
    token = _INPUTS.set(True)
    try:
        with implicit_replication():
            yield
    finally:
        _INPUTS.reset(token)


def whole(x):
    """The whole of ``x`` as a plain tensor in every rank: a ``DTensor``
    replicated (its shards gathered, a partial sum reduced) and its local
    tensor taken; a plain tensor as it is. Differentiable."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh,
                          (Replicate(),) * x.device_mesh.ndim).to_local()


def replicated_like(x, ref):
    """Plain ``x``, the same in every rank, as a replicated ``DTensor`` on
    ``ref``'s mesh where ``ref`` is a ``DTensor``; else ``x`` as it is.
    Differentiable."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(ref, DTensor):
        return x
    mesh = ref.device_mesh
    return DTensor.from_local(x, mesh, (Replicate(),) * mesh.ndim,
                              run_check=False)
