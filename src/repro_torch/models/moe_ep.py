"""Explicit expert-parallel MoE over an axis of ranks — the counterpart of
``repro.models.moe_ep``.

The mesh variant of ``models.moe`` leaves the experts' placement to
``DTensor``; this module writes the dispatch's collectives out: each rank
routes its own tokens, buckets the assignments by global expert with a
stable sort, packs them into per-destination capacity buckets, exchanges
them with ONE all-to-all over the axis, runs its local experts, and sends
the outputs back with a second all-to-all. It is the mesh-scale rendering
of the paper's phases 2 and 3 (distribute into sub-arrays, process each in
parallel), with ranks as the sub-arrays.

The combine is the port's fixed-order one (``models.moe``): each
assignment's output back at its token-major place by the permutation, then
each token's top_k summed in order, where the reference scatter-adds in
sorted order; so a run gives the same bits every time.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..parallel.compat import all_to_all, axis_size, psum
from .config import ModelConfig
from .moe import _combine, _pack, _route, capacity

__all__ = ["ep_moe_shard", "ep_moe"]


def ep_moe_shard(cfg: ModelConfig, xf, router_w, w_in_local, w_out_local,
                 group=None):
    """One rank's part. Per rank:
      xf            (T_loc, d)      the local tokens
      router_w      (d, E)          the whole router
      w_in_local    (E_loc, d, f*)  this rank's experts
      w_out_local   (E_loc, f, d)
    Returns ``(y (T_loc, d), aux-loss shaped (1,))``."""
    m = cfg.moe
    p = axis_size(group)
    t_loc, dm = xf.shape
    e, e_loc = m.n_experts, m.n_experts // p
    cap = capacity(cfg, t_loc)      # per (local tokens, global experts)

    # --- route (the math of models.moe) ---
    top_p, top_e, aux = _route(cfg, router_w, xf)

    # --- the paper's technique: bucket assignments by (global) expert ---
    n = t_loc * m.top_k
    flat_e = top_e.reshape(n)
    order = torch.argsort(flat_e, stable=True)
    send, slot = _pack(xf, m.top_k, flat_e[order], order, e, cap)
    send = send.reshape(p, e_loc * cap, dm)

    # --- ONE all_to_all out: rows become (source rank, local expert, cap) ---
    recv = all_to_all(send, group)
    buf = recv.reshape(p, e_loc, cap, dm).transpose(0, 1).reshape(
        e_loc, p * cap, dm)

    # --- the local experts, batched ---
    dt = buf.dtype
    h = torch.bmm(buf, w_in_local.to(dt))
    if cfg.mlp_gated:
        u, g = torch.chunk(h, 2, dim=-1)
        h = u * F.silu(g)
    else:
        h = F.silu(h)
    out = torch.bmm(h, w_out_local.to(dt))

    # --- all_to_all back, undo the permutation, combine with the gates ---
    back = out.reshape(e_loc, p, cap, dm).transpose(0, 1).reshape(
        p, e_loc * cap, dm)
    ret = all_to_all(back, group)
    y = _combine(ret.reshape(e * cap, dm), slot, order, top_p.reshape(n),
                 m.top_k)
    return y, aux[None]


def ep_moe(cfg: ModelConfig, mesh, axis_name: str, xf, router_w, w_in,
           w_out):
    """The tokens ``xf`` ``(T, d)`` and the experts ``w_in``, ``w_out``
    split over ``mesh``'s dimension ``axis_name``, the router replicated;
    each argument a ``DTensor`` on ``mesh`` or a plain tensor the same in
    every rank. Every rank of the mesh calls it. Returns ``(y, aux)``: ``y``
    a ``DTensor`` split on its tokens as ``xf``, ``aux`` the sum of the
    ranks' aux losses."""
    from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                          distribute_tensor)
    dim = mesh.mesh_dim_names.index(axis_name)
    split = tuple(Shard(0) if i == dim else Replicate()
                  for i in range(mesh.ndim))
    whole = (Replicate(),) * mesh.ndim

    def local(t, placed):
        if isinstance(t, DTensor):
            return t.redistribute(mesh, placed).to_local()
        return distribute_tensor(t, mesh, placed,
                                 src_data_rank=None).to_local()

    group = mesh.get_group(axis_name)
    y, aux = ep_moe_shard(cfg, local(xf, split), local(router_w, whole),
                          local(w_in, split), local(w_out, split), group)
    return (DTensor.from_local(y, mesh, split, run_check=False),
            psum(aux, group)[0])
