"""Mixture-of-Experts layer with *sort-based* token dispatch — the paper's
bucketing technique in the forward pass; the counterpart of
``repro.models.moe``.

Routing is the paper's problem: distribute elements (tokens) into
sub-arrays (experts) and process every sub-array in parallel. The 'sort'
dispatch buckets by sorting the flat (token, expert) assignment list by
expert id, then computes all experts batched; 'einsum' is the one-hot
dispatch baseline.

``sort_impl`` picks the sort of the assignment list:
  * 'xla' — ``torch.argsort(stable=True)``;
  * 'oets' — the paper's parallel bubble sort as torch ops
    (``core.oets.oets_sort_kv``, stable);
  * 'bitonic' — the bitonic network (``core.bitonic.bitonic_sort_kv``; not
    stable, and it gives the reference's exact permutation);
  * 'pallas' — ``kernels.ops.sort_kv``, the hand-written kernels on the
    card (B1 up to 128 assignments, B2 up to 1024, blocksort's B2 and B4
    beyond), their plain versions on the CPU. The iota payload breaks
    ties, so its permutation is the stable argsort's.

Capacity is ``int(capacity_factor * t * top_k / n_experts)`` rounded up to
a multiple of 8 and at least 8, over all ``t = B*T`` tokens, and the flat
assignment order is token-major; assignments past an expert's capacity are
dropped, so which ones drop depends on the order — padding tokens route
and use capacity too, as in the reference.

The dispatch's backward pass is deterministic too: every gather is by a
permutation, or by slots that are unique but for the dropped rows' spare
one, whose gradient is zero, so no gradient row sums in an order a card
may change.

Under a mesh (the parameters ``DTensor``s, ``parallel.compat.set_mesh``)
the router and the whole token list are taken replicated as plain tensors
in every rank (``sharding.whole``): the routing, the sort of the whole
assignment list — the hand-written kernels read plain tensors — and the
gathers by the permutation run the same in every rank and give the
single-device permutation and drops. Only the experts' products run as
``DTensor``s, their buffer placed by ``act_expert`` (expert parallelism on
``model``); the output comes back replicated.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.bitonic import bitonic_sort_kv
from ..core.oets import oets_sort_kv
from ..kernels.ops import sort_kv as kernel_sort_kv
from ..parallel.sharding import Rules, constrain, replicated_like, whole
from .config import ModelConfig
from .layers import ACTS, MLP, mlp
from .param import Builder, ParamModule

__all__ = ["MoE", "init_moe", "moe", "capacity"]


def capacity(cfg: ModelConfig, n_tokens: int) -> int:
    m = cfg.moe
    c = int(m.capacity_factor * n_tokens * m.top_k / m.n_experts)
    return max(8, -(-c // 8) * 8)


class MoE(ParamModule):
    """Router ``(d_model, n_experts)``, experts ``w_in`` ``(E, d_model,
    2*d_expert | d_expert)`` and ``w_out`` ``(E, d_expert, d_model)``, and a
    shared-expert MLP where the config has one."""

    def __init__(self, b: Builder, cfg: ModelConfig):
        super().__init__()
        m = cfg.moe
        dm = cfg.d_model
        w_in_cols = 2 * m.d_expert if cfg.mlp_gated else m.d_expert
        self.router = b.param((dm, m.n_experts), ("embed", "expert"),
                              scale=dm ** -0.5)
        self.w_in = b.param((m.n_experts, dm, w_in_cols),
                            ("expert", "embed", "expert_mlp"))
        self.w_out = b.param((m.n_experts, m.d_expert, dm),
                             ("expert", "expert_mlp", "embed"))
        if m.n_shared:
            self.shared = MLP(b, dm, m.n_shared * m.d_shared, cfg.mlp_gated)


init_moe = MoE


def _counts(ids: torch.Tensor, n: int) -> torch.Tensor:
    """How many of ``ids`` name each of ``0..n-1``: a scatter-add of ones,
    exact in any order, and without the host sync of ``torch.bincount``
    on a card."""
    ids = ids.reshape(-1).long()
    return torch.zeros(n, dtype=torch.long, device=ids.device).scatter_add_(
        0, ids, torch.ones_like(ids))


def _top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest, the lower expert id first among
    equal probabilities (a stable descending sort; ``torch.topk`` promises
    no order on ties)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(cfg, router, xf):
    """Router logits (float32) -> (top-k probs, top-k expert ids, aux
    load-balance loss)."""
    m = cfg.moe
    logits = xf.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = _top_k(probs, m.top_k)
    if m.router_renorm:
        top_p = top_p / top_p.sum(dim=-1, keepdim=True)
    # Switch-style load-balance aux: E * sum_e (token_frac_e * prob_mass_e)
    t = xf.shape[0]
    token_frac = _counts(top_e, m.n_experts).float() / (t * m.top_k)
    prob_mass = probs.mean(dim=0)
    aux = m.aux_alpha * m.n_experts * torch.sum(token_frac * prob_mass)
    return top_p, top_e, aux


def _expert_ffn(cfg, p, buf, rules):
    """buf ``(E, C, d)`` -> ``(E, C, d)``, batched over experts. Under a
    mesh the plain buffer is placed by ``act_expert`` beside the experts'
    shards and the output taken whole again."""
    buf = constrain(replicated_like(buf, p.w_in), rules, "act_expert", None,
                    "act_embed")
    dt = buf.dtype
    h = torch.bmm(buf, p.w_in.to(dt))
    if cfg.mlp_gated:
        u, g = torch.chunk(h, 2, dim=-1)
        h = u * ACTS[cfg.mlp_act](g)
    else:
        h = ACTS[cfg.mlp_act](h)
    return whole(torch.bmm(h, p.w_out.to(dt)))


def _sort_assignments(flat_e, flat_payload, impl: str):
    """``(sorted expert ids, payload in the same order)`` by ``impl``."""
    if impl == "xla":
        order = torch.argsort(flat_e, stable=True)
        return flat_e[order], flat_payload[order]
    if impl == "oets":
        return oets_sort_kv(flat_e, flat_payload)
    if impl == "bitonic":
        return bitonic_sort_kv(flat_e, flat_payload)
    if impl == "pallas":
        return kernel_sort_kv(flat_e, flat_payload)
    raise ValueError(f"unknown sort impl {impl!r}")


def _pack(xf, top_k: int, sorted_e, perm, n_experts: int, cap: int):
    """The assignments in the sorted order ``(sorted_e, perm)`` (expert ids
    and token-major indices, ``int64``) packed into ``n_experts`` capacity
    buckets of ``cap`` rows: each one's rank within its expert, those past
    ``cap`` dropped. Returns ``(buffer (n_experts * cap, d), slot)``,
    ``slot`` each sorted assignment's row (``n_experts * cap`` if
    dropped)."""
    t, dm = xf.shape
    n = t * top_k
    counts = _counts(sorted_e, n_experts)
    offsets = torch.cumsum(counts, 0) - counts
    rank = torch.arange(n, device=xf.device) - offsets[sorted_e]
    slot = torch.where(rank < cap, sorted_e * cap + rank, n_experts * cap)
    # each assignment's row, gathered by the permutation from a token-major
    # copy: the reference's xf[sorted_t]. Its transpose (:func:`_combine`)
    # is then a scatter by a permutation (one row each) and a sum over
    # top_k in a fixed order; xf[sorted_t]'s would sum each token's top_k
    # rows in no fixed order.
    rows = xf[:, None, :].expand(t, top_k, dm).reshape(n, dm)[perm]
    buf = xf.new_zeros((n_experts * cap + 1, dm))
    buf[slot] = rows                    # dropped ones share the spare row
    return buf[: n_experts * cap], slot


def _combine(out, slot, perm, gates, top_k: int):
    """The experts' outputs ``out`` ``(n_experts * cap, d)`` back to the
    tokens: each sorted assignment's row (zeros where dropped) at its
    token-major place — ``perm`` is a permutation, so every row is written
    once — gated, and each token's ``top_k`` summed in a fixed order. The
    reference scatter-adds in sorted order (``.at[sorted_t].add``); on a
    card that is atomics, whose order — and so the low bits of every later
    layer and its routing — would change from run to run."""
    dm = out.shape[1]
    contrib = torch.cat([out, out.new_zeros((1, dm))])[slot]
    back = torch.empty_like(contrib)
    back[perm] = contrib
    return (back * gates[:, None].to(out.dtype)).reshape(
        -1, top_k, dm).sum(1)


def _dispatch_sort(cfg, p, router, xf, rules, sort_impl):
    """The paper's dispatch: bucket the assignments by expert with a
    key-value sort, rank each within its bucket, drop past capacity."""
    m = cfg.moe
    t, dm = xf.shape
    dev = xf.device
    cap = capacity(cfg, t)
    top_p, top_e, aux = _route(cfg, router, xf)

    n = t * m.top_k
    flat_e = top_e.reshape(n).to(torch.int32)
    flat_p = top_p.reshape(n)

    iota = torch.arange(n, dtype=torch.int32, device=dev)
    sorted_e, perm = _sort_assignments(flat_e, iota, sort_impl)
    sorted_e, perm = sorted_e.long(), perm.long()
    buf, slot = _pack(xf, m.top_k, sorted_e, perm, m.n_experts, cap)
    out = _expert_ffn(cfg, p, buf.reshape(m.n_experts, cap, dm), rules)
    y = _combine(out.reshape(m.n_experts * cap, dm), slot, perm, flat_p,
                 m.top_k)
    return y, aux


def _dispatch_einsum(cfg, p, router, xf, rules):
    """One-hot dispatch baseline (no sort)."""
    m = cfg.moe
    t, dm = xf.shape
    cap = capacity(cfg, t)
    top_p, top_e, aux = _route(cfg, router, xf)

    # position of each assignment within its expert bucket
    onehot = F.one_hot(top_e, m.n_experts).to(torch.int32)      # (t,k,E)
    pos = torch.cumsum(onehot.reshape(t * m.top_k, m.n_experts), 0,
                       dtype=torch.int32).reshape(t, m.top_k, m.n_experts) \
        * onehot - 1
    within_cap = (pos >= 0) & (pos < cap)
    combine = (top_p[..., None] * within_cap).float()            # (t,k,E)
    disp = F.one_hot(torch.where(within_cap, pos, cap).long(),
                     cap + 1).to(xf.dtype)[..., :cap] \
        * within_cap[..., None].to(xf.dtype)                      # (t,k,E,C)

    buf = torch.einsum("td,tkec->ecd", xf, disp)
    out = _expert_ffn(cfg, p, buf, rules)
    y = torch.einsum("tkec,ecd->td", (combine[..., None] * disp).to(xf.dtype),
                     out)
    return y, aux


def moe(cfg: ModelConfig, p, x, rules: Rules, sort_impl: str = "xla"):
    """x ``(B, T, d)`` -> ``(y (B, T, d), aux_loss scalar)``."""
    m = cfg.moe
    b, t, dm = x.shape
    xf = x.reshape(b * t, dm)
    # the dispatch's index arithmetic, its sort kernels and its gathers by
    # the permutation take plain tensors: the whole token list and router
    # in every rank under a mesh (the module's docstring)
    router, xw = whole(p.router), whole(xf)
    if m.impl == "sort":
        y, aux = _dispatch_sort(cfg, p, router, xw, rules, sort_impl)
    elif m.impl == "einsum":
        y, aux = _dispatch_einsum(cfg, p, router, xw, rules)
    else:
        raise ValueError(f"unknown moe impl {m.impl!r}")
    # shaped as x while plain, then placed as the residual stream under a
    # mesh (a view of the replicated output would be flattened again in the
    # backward pass beside a split axis, which torch 2.11's DTensor cannot)
    y = constrain(replicated_like(y.reshape(b, t, dm), xf), rules, "batch",
                  "res_seq", "act_embed")
    aux = replicated_like(aux, xf)
    if m.n_shared:
        y = y + mlp(p.shared, x, cfg.mlp_act, cfg.mlp_gated, rules)
    return y, aux
