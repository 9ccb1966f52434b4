"""The mesh collectives of the port over ``torch.distributed`` — the
counterpart of ``repro.parallel.compat``'s ``shard_map`` helpers
(``axis_size``), ``make_mesh`` and the active mesh (``set_mesh``,
``get_abstract_mesh``: here :func:`set_mesh` and :func:`get_mesh`).

The reference's engines run inside ``shard_map`` and talk through
``lax.axis_index``, ``lax.ppermute``, ``lax.all_gather`` and
``lax.all_to_all`` over a named mesh axis. Here every rank is a process, the
axis is a ``ProcessGroup`` (the group of one named dimension of a
``DeviceMesh``, :func:`make_mesh`), and these five functions are the only
collective steps the engines take:

  * :func:`axis_size` / :func:`axis_index` — the group's size and this
    rank's place in it;
  * :func:`ppermute` — the ring shift, one ``batch_isend_irecv`` that sends
    to ``(me + shift) % P`` and receives from ``(me - shift) % P``;
  * :func:`all_gather` — every rank's tensor stacked on a new leading axis;
  * :func:`all_to_all` — block ``d`` of the leading axis to rank ``d``,
    block ``s`` of the result from rank ``s`` (``all_to_all_single``);
  * :func:`psum` / :func:`pmax` — the sum and the maximum over the ranks
    (``all_reduce``), the one step that adds values and so keeps the dtype.

Every tensor crosses as its raw bytes (a ``uint8`` view of its last axis),
so any dtype travels — ``torch.uint32`` and the narrow lanes included, which
the backends do not all take — and bits never change. Which memory a
collective reads is chosen by the group's backend, read with
``dist.get_backend(group)``, never by catching an error: ``gloo`` takes host
tensors only, so a CUDA operand is copied to the host, sent, and the result
copied back to its device (on one card, several ranks share ``cuda:0`` this
way; NCCL refuses two ranks on one GPU); ``nccl`` takes the CUDA tensors as
they are.

A ``DTensor``'s redistributions call c10d's functional collectives on the
local tensors. gloo runs them on CUDA operands itself, copying through the
host, but one: its ``allgather_into_tensor_coalesced``, behind
``all_gather_into_tensor``, crashes the process on CUDA tensors (torch
2.11, a segmentation fault). So :func:`make_mesh` of a CUDA mesh over a
gloo group gives that op's CUDA kernel a route of its own
(:func:`_all_gather_route`): the group's backend decides, as above — a host
copy and gloo's plain all-gather where it is gloo, the device tensors
where it is not.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
from typing import Sequence

import torch
import torch.distributed as dist

__all__ = ["axis_size", "axis_index", "ppermute", "all_gather", "all_to_all",
           "psum", "pmax", "make_mesh", "set_mesh", "get_mesh"]


def axis_size(group=None) -> int:
    """The number of ranks along the axis of ``group`` (None: the world)."""
    return dist.get_world_size(group)


def axis_index(group=None) -> int:
    """This rank's index along the axis of ``group``."""
    return dist.get_rank(group)


def _on_host(group) -> bool:
    return dist.get_backend(group) == dist.Backend.GLOO


def _wire(x: torch.Tensor, group) -> torch.Tensor:
    """``x``'s bytes as a contiguous ``uint8`` tensor (last axis scaled by
    the item size) where the group's backend reads it."""
    x = x.contiguous()
    if x.dim() == 0:
        x = x.reshape(1)
    b = x.view(torch.uint8)
    return b.cpu() if _on_host(group) else b


def _unwire(b: torch.Tensor, like: torch.Tensor, shape) -> torch.Tensor:
    """Bytes received for a tensor like ``like`` back as its dtype, on its
    device, in ``shape``."""
    return b.to(like.device).view(like.dtype).reshape(shape)


def _global(group, index: int) -> int:
    return index if group is None else dist.get_global_rank(group, index)


def ppermute(x: torch.Tensor, group=None, shift: int = 1) -> torch.Tensor:
    """The ring shift ``lax.ppermute(x, axis, [(i, (i + shift) % P)])``:
    this rank's ``x`` goes to rank ``(me + shift) % P`` and the result is
    the ``x`` of rank ``(me - shift) % P``. At one rank it is ``x``."""
    num, me = axis_size(group), axis_index(group)
    if num == 1 or shift % num == 0:
        return x.clone()
    send = _wire(x, group)
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, _global(group, (me + shift) % num),
                      group),
           dist.P2POp(dist.irecv, recv, _global(group, (me - shift) % num),
                      group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return _unwire(recv, x, x.shape)


def all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """``lax.all_gather(x, axis)``: every rank's ``x`` (same shape on each)
    stacked on a new leading axis in rank order."""
    num = axis_size(group)
    send = _wire(x, group)
    out = [torch.empty_like(send) for _ in range(num)]
    dist.all_gather(out, send, group=group)
    return _unwire(torch.stack(out), x, (num,) + tuple(x.shape))


def all_to_all(x: torch.Tensor, group=None) -> torch.Tensor:
    """``lax.all_to_all(x, axis, split_axis=0, concat_axis=0, tiled=False)``
    over a ``(P, ...)`` tensor: block ``d`` goes to rank ``d``; block ``s``
    of the result came from rank ``s``."""
    num = axis_size(group)
    if x.shape[0] != num:
        raise ValueError(f"all_to_all needs a leading axis of {num}, got "
                         f"{tuple(x.shape)}")
    send = _wire(x.reshape(num, -1), group)
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return _unwire(recv, x, x.shape)


def _reduce(x: torch.Tensor, group, op) -> torch.Tensor:
    """``x`` reduced by ``op`` over the ranks of ``group``, on ``x``'s
    device: a host copy where the backend is gloo, as :func:`_wire`
    decides. Unlike the byte-moving steps above this one adds values, so
    ``x`` crosses in its own dtype."""
    buf = x.detach().clone()
    if _on_host(group):
        buf = buf.cpu()
    dist.all_reduce(buf, op=op, group=group)
    return buf.to(x.device)


def psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """``lax.psum(x, axis)``: the sum of every rank's ``x``."""
    return _reduce(x, group, dist.ReduceOp.SUM)


def pmax(x: torch.Tensor, group=None) -> torch.Tensor:
    """``lax.pmax(x, axis)``: the elementwise maximum over the ranks."""
    return _reduce(x, group, dist.ReduceOp.MAX)


_MESH: contextvars.ContextVar = contextvars.ContextVar("mesh", default=None)


@contextlib.contextmanager
def set_mesh(mesh):
    """Make ``mesh`` (a ``DeviceMesh``) the active mesh for the block, as
    ``jax.set_mesh`` does: ``sharding.constrain`` places activations on it
    and the model's entry points take plain tensors beside its
    ``DTensor``s as replicated. It is a context variable: another thread
    (autograd's, in a CUDA backward pass) does not see it, so a
    checkpointed block's recompute enters it again (``models.model``)."""
    token = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(token)


def get_mesh():
    """The active mesh of :func:`set_mesh`, or ``None`` outside one (the
    reference's empty abstract mesh)."""
    return _MESH.get()


def _all_gather_into_tensor(x: torch.Tensor, group_size: int,
                            group_name: str) -> torch.Tensor:
    """``_c10d_functional.all_gather_into_tensor`` for CUDA operands: every
    rank's ``x`` concatenated on dim 0, through the host where the group's
    backend is gloo. Synchronous, so the functional op's ``wait_tensor``
    finds no work left."""
    from torch.distributed.distributed_c10d import _resolve_process_group
    group = _resolve_process_group(group_name)
    src = x.contiguous()
    if _on_host(group):
        src = src.cpu()
    out = src.new_empty((group_size * src.shape[0],) + tuple(src.shape[1:]))
    dist.all_gather_into_tensor(out, src, group=group)
    return out.to(x.device)


@functools.cache
def _all_gather_route():
    """Register :func:`_all_gather_into_tensor` as the CUDA kernel of
    ``_c10d_functional.all_gather_into_tensor`` in this process, once;
    the ``Library`` returned (and cached) keeps it registered."""
    lib = torch.library.Library("_c10d_functional", "IMPL")
    lib.impl("all_gather_into_tensor", _all_gather_into_tensor, "CUDA")
    return lib


def make_mesh(shape: Sequence[int], names: Sequence[str],
              device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` with dimension ``names`` over the ranks
    of the default process group (``init_device_mesh``; the group is set up
    first if it is not). The engines take ``mesh.get_group(name)``. A CUDA
    mesh over gloo routes the functional all-gather through the host (the
    module's docstring)."""
    from torch.distributed.device_mesh import init_device_mesh
    mesh = init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(names))
    if device_type == "cuda" and _on_host(None):
        _all_gather_route()
    return mesh
