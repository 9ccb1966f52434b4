"""Attention — the counterpart of ``repro.models.attention``: grouped-query
attention (GQA; llama3, glm4, nemotron, granite, ...) and multi-head latent
attention (MLA; deepseek-v2, minicpm3), each with its training, prefill
(cache-building) and decode (cache-consuming) paths.

The math stays in the reference's plain ops — einsums and a masked softmax
in float32 — so both packages compute the same numbers; no kernel computes
it, and ``scaled_dot_product_attention`` would change them. Masked scores
take ``finfo(float32).min``, not ``-inf``; the streaming path
(:func:`_gqa_chunked`) uses ``-inf`` with a finite guard, as the reference
does.

MLA caches the compressed latent ``ckv`` and one shared rope key ``kr`` a
token. Prefill takes the naive path (per-head keys and values materialised
from the latent), decode the absorbed one (queries projected into the
latent, attention against the cache as it is), each as the reference has
it: the two round differently in bfloat16, so one path for both would give
other tokens than the reference's.

A decode step writes the new entry into the cache tensors *in place* and
returns them: the caller's cache is the step's cache. Rows whose index is
past the cache are not written, as in the reference's per-row write.
"""

from __future__ import annotations

import torch
from torch import nn

from ..parallel.sharding import (Rules, constrain, constrain_core,
                                 replicated_like)
from .config import ModelConfig
from .layers import Norm, apply_rope, rmsnorm
from .param import Builder, ParamModule

__all__ = ["Attention", "MLA", "init_attention", "attention",
           "init_attn_cache"]

_NEG = torch.finfo(torch.float32).min


def _softmax_attend(scores, mask, dtype):
    scores = scores.float().masked_fill(~mask, _NEG)
    return torch.softmax(scores, dim=-1).to(dtype)


def _causal_mask(t: int, s: int, device):
    # queries occupy the last t positions of an s-length context
    q_pos = torch.arange(t, device=device)[:, None] + (s - t)
    return q_pos >= torch.arange(s, device=device)[None, :]


def _as_index(cur_index, device) -> torch.Tensor:
    return torch.as_tensor(cur_index, device=device).long()


def _decode_mask(s: int, cur_index, extra_dims: int, device):
    """Valid context of a one-token decode: positions ``<= cur_index``.
    ``cur_index`` scalar (synchronised decode) or ``(B,)`` (each request
    at its own position); shaped ``(B|1, 1*extra, 1, s)``."""
    cur = _as_index(cur_index, device)
    pos = torch.arange(s, device=device)
    if cur.dim() == 0:
        return (pos <= cur).reshape((1,) * (extra_dims + 1) + (s,))
    m = pos[None, :] <= cur[:, None]                    # (B, s)
    return m.reshape((m.shape[0],) + (1,) * extra_dims + (s,))


def _cache_write(cache_arr, new, cur_index):
    """Write the one-token entry ``new`` ``(B, 1, ...)`` into ``cache_arr``
    ``(B, s, ...)`` at ``cur_index``, in place. A scalar index is clamped
    into the cache (``dynamic_update_slice``'s rule); a per-row ``(B,)``
    index writes no row whose index is outside it (the reference's one-hot
    select). A sharded cache (a ``DTensor``) takes ``new`` in its own
    placements, and each rank writes its own rows."""
    from torch.distributed.tensor import DTensor
    if isinstance(cache_arr, DTensor):
        _sharded_cache_write(cache_arr, new, cur_index)
        return cache_arr
    new = new[:, 0].to(cache_arr.dtype)
    s = cache_arr.shape[1]
    cur = _as_index(cur_index, cache_arr.device)
    rows = torch.arange(cache_arr.shape[0], device=cache_arr.device)
    if cur.dim() == 0:
        cache_arr[rows, cur.clamp(0, s - 1)] = new
        return cache_arr
    inside = (cur >= 0) & (cur < s)
    col = cur.clamp(0, s - 1)
    keep = inside.reshape((-1,) + (1,) * (new.dim() - 1))
    cache_arr[rows, col] = torch.where(keep, new, cache_arr[rows, col])
    return cache_arr


def _sharded_cache_write(cache_arr, new, cur_index):
    """:func:`_cache_write` on each rank's shard of a ``DTensor`` cache:
    ``new`` redistributed to the cache's placements (its dimensions are
    the cache's but the length-1 position axis, which a cache is not split
    on), a per-row index split over the batch as the cache is, and the
    local tensors written in place."""
    from torch.distributed.tensor import Replicate, Shard
    mesh, pl = cache_arr.device_mesh, cache_arr.placements
    if any(p == Shard(1) for p in pl):
        raise ValueError("a decode cache split on its position axis is not "
                         "supported")
    new = new.to(cache_arr.dtype).redistribute(mesh, pl).to_local()
    cur = _as_index(cur_index, new.device)
    if cur.dim() == 1:
        rows = tuple(Shard(0) if p == Shard(0) else Replicate() for p in pl)
        cur = replicated_like(cur, cache_arr).redistribute(mesh,
                                                           rows).to_local()
    _cache_write(cache_arr.to_local(), new, cur)


# ---------------- GQA ----------------

def _gqa_chunked(q, keys, vals, scale, chunk, dt):
    """Streaming-softmax attention over KV chunks (the flash-attention
    pattern): never materialises the ``(T, S)`` scores; running max,
    normaliser and accumulator are corrected chunk by chunk. q ``(B, T, kh,
    g, d)``; keys/vals ``(B, S, kh, d)``. Causal. Returns ctx ``(B, T, kh,
    g, d)``."""
    b, t, kh, g, d = q.shape
    s = keys.shape[1]
    dev = q.device
    q_pos = torch.arange(t, device=dev)[:, None] + (s - t)
    m = torch.full((b, kh, g, t), float("-inf"), device=dev)
    l = torch.zeros((b, kh, g, t), device=dev)
    acc = torch.zeros((b, t, kh, g, d), device=dev)
    for i in range(s // chunk):
        ks = keys[:, i * chunk:(i + 1) * chunk]
        vs = vals[:, i * chunk:(i + 1) * chunk]
        sc = torch.einsum("btkgd,bskd->bkgts", q, ks).float() * scale
        col = i * chunk + torch.arange(chunk, device=dev)
        sc = sc.masked_fill(~(q_pos >= col[None, :]), float("-inf"))
        m_new = torch.maximum(m, sc.amax(dim=-1))
        finite = torch.isfinite(m_new)
        corr = torch.where(finite, torch.exp(m - m_new), 1.0)
        p = torch.where(finite[..., None], torch.exp(sc - m_new[..., None]),
                        0.0)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bkgts,bskd->btkgd", p.to(dt), vs).float()
        acc = acc * corr.movedim(3, 1)[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l.movedim(3, 1)[..., None], min=1e-30)
    return out.to(dt)


class Attention(ParamModule):
    """GQA weights: ``wq`` ``(d_model, heads, head_dim)``, ``wk``/``wv``
    ``(d_model, kv_heads, head_dim)``, ``wo`` ``(heads, head_dim,
    d_model)``."""

    def __init__(self, b: Builder, cfg: ModelConfig):
        super().__init__()
        dm, h, k, d = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        self.wq = b.param((dm, h, d), ("embed", "heads", None))
        self.wk = b.param((dm, k, d), ("embed", "kv_heads", None))
        self.wv = b.param((dm, k, d), ("embed", "kv_heads", None))
        self.wo = b.param((h, d, dm), ("heads", None, "embed"))


def _gqa(cfg, p, x, cos, sin, rules, cache, cur_index, return_cache):
    B, T = x.shape[:2]
    h, kh, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    g = cfg.q_per_kv
    dt = x.dtype

    q = torch.einsum("btd,dhk->bthk", x, p.wq.to(dt))
    k = torch.einsum("btd,dhk->bthk", x, p.wk.to(dt))
    v = torch.einsum("btd,dhk->bthk", x, p.wv.to(dt))
    if cfg.rope_kind != "none":
        q = apply_rope(q, cos, sin, cfg.rope_pct)
        k = apply_rope(k, cos, sin, cfg.rope_pct)
    q = constrain(q, rules, "batch", "seq", "act_heads", None)

    if cache is not None:
        # decode: T == 1; write the new KV at cur_index, attend the prefix
        keys = _cache_write(cache["k"], k, cur_index)
        vals = _cache_write(cache["v"], v, cur_index)
        s = keys.shape[1]
        mask = _decode_mask(s, cur_index, 3, x.device)  # (B|1,1,1,1,s)
        new_cache = {"k": keys, "v": vals}
        keys, vals = keys.to(dt), vals.to(dt)
    else:
        keys, vals = k, v
        mask = _causal_mask(T, T, x.device)
        new_cache = {"k": k, "v": v} if return_cache else None

    qg, keys, vals = (constrain_core(t, rules)
                      for t in (q.reshape(B, T, kh, g, d), keys, vals))
    s_len = keys.shape[1]
    chunk = cfg.attn_kv_chunk
    if (cache is None and chunk and T > 1 and s_len > chunk
            and s_len % chunk == 0):
        # streaming attention: O(T*chunk) live scores instead of O(T*S)
        ctx = _gqa_chunked(qg, keys, vals, d ** -0.5, chunk, dt)
        ctx = ctx.reshape(B, T, h, d)
    else:
        scores = torch.einsum("btkgd,bskd->bkgts", qg, keys) * (d ** -0.5)
        probs = _softmax_attend(scores, mask, dt)
        ctx = torch.einsum("bkgts,bskd->btkgd", probs, vals)
        ctx = ctx.reshape(B, T, h, d)
    # wo whole over its heads, as the core's heads are (the product flattens
    # them with head_dim, which torch 2.11's DTensor cannot while they are
    # split; the identity on one device)
    wo = constrain(p.wo.to(dt), rules, None, None, "embed")
    out = torch.einsum("bthd,hdm->btm", ctx, wo)
    return out, new_cache


# ---------------- MLA ----------------

class MLA(ParamModule):
    """MLA weights: ``wkv_a`` ``(d_model, kv_lora + qk_rope)``, ``kv_norm``,
    ``wkv_b`` ``(kv_lora, heads, qk_nope + v_head)``, ``wo`` ``(heads,
    v_head, d_model)``, and the queries' ``wq_a`` ``(d_model, q_lora)``,
    ``q_norm`` and ``wq_b`` ``(q_lora, heads, qk_nope + qk_rope)`` — or,
    with ``q_lora`` 0, ``wq`` ``(d_model, heads, qk_nope + qk_rope)``."""

    def __init__(self, b: Builder, cfg: ModelConfig):
        super().__init__()
        m = cfg.mla
        dm, h = cfg.d_model, cfg.n_heads
        self.wkv_a = b.param((dm, m.kv_lora + m.qk_rope),
                             ("embed", "kv_lora"))
        self.kv_norm = Norm(b, m.kv_lora)
        self.wkv_b = b.param((m.kv_lora, h, m.qk_nope + m.v_head),
                             ("kv_lora", "heads", None))
        self.wo = b.param((h, m.v_head, dm), ("heads", None, "embed"))
        if m.q_lora:
            self.wq_a = b.param((dm, m.q_lora), ("embed", "q_lora"))
            self.q_norm = Norm(b, m.q_lora)
            self.wq_b = b.param((m.q_lora, h, m.qk_nope + m.qk_rope),
                                 ("q_lora", "heads", None))
        else:
            self.wq = b.param((dm, h, m.qk_nope + m.qk_rope),
                               ("embed", "heads", None))


def _mla_queries(cfg, p, x, cos, sin):
    m = cfg.mla
    dt = x.dtype
    if m.q_lora:
        cq = rmsnorm(p.q_norm, x @ p.wq_a.to(dt), cfg.norm_eps)
        q = torch.einsum("btq,qhk->bthk", cq, p.wq_b.to(dt))
    else:
        q = torch.einsum("btd,dhk->bthk", x, p.wq.to(dt))
    qn, qr = q[..., :m.qk_nope], q[..., m.qk_nope:]
    return qn, apply_rope(qr, cos, sin)


def _mla(cfg, p, x, cos, sin, rules, cache, cur_index, return_cache):
    m = cfg.mla
    T = x.shape[1]
    dt = x.dtype
    scale = (m.qk_nope + m.qk_rope) ** -0.5

    qn, qr = _mla_queries(cfg, p, x, cos, sin)
    qn = constrain(qn, rules, "batch", "seq", "act_heads", None)

    ckv_full = x @ p.wkv_a.to(dt)
    ckv, kr = ckv_full[..., :m.kv_lora], ckv_full[..., m.kv_lora:]
    ckv = rmsnorm(p.kv_norm, ckv, cfg.norm_eps)
    kr = apply_rope(kr[:, :, None, :], cos, sin)[:, :, 0, :]  # one shared head

    wkv_b = p.wkv_b.to(dt)
    if cache is not None:
        # absorbed decode: attend in the compressed latent space
        ckv_c = _cache_write(cache["ckv"], ckv, cur_index)
        kr_c = _cache_write(cache["kr"], kr, cur_index)
        mask = _decode_mask(ckv_c.shape[1], cur_index, 2, x.device)
        new_cache = {"ckv": ckv_c, "kr": kr_c}
        ckv_all, kr_all, qn, qr = (
            constrain_core(t, rules)
            for t in (ckv_c.to(dt), kr_c.to(dt), qn, qr))
        w_uk, w_uv = wkv_b[..., :m.qk_nope], wkv_b[..., m.qk_nope:]
        q_lat = torch.einsum("bthn,chn->bthc", qn, w_uk)
        scores = (torch.einsum("bthc,bsc->bhts", q_lat, ckv_all)
                  + torch.einsum("bthr,bsr->bhts", qr, kr_all)) * scale
        probs = _softmax_attend(scores, mask, dt)
        ctx_lat = torch.einsum("bhts,bsc->bthc", probs, ckv_all)
        ctx = torch.einsum("bthc,chv->bthv", ctx_lat, w_uv)
    else:
        # naive train / prefill: per-head keys and values from the latent
        kv = torch.einsum("btc,chn->bthn", ckv, wkv_b)
        kn, v = kv[..., :m.qk_nope], kv[..., m.qk_nope:]
        mask = _causal_mask(T, T, x.device)
        qn_c, qr_c, kn, v, kr_c = (constrain_core(t, rules)
                                   for t in (qn, qr, kn, v, kr))
        scores = (torch.einsum("bthn,bshn->bhts", qn_c, kn)
                  + torch.einsum("bthr,bsr->bhts", qr_c, kr_c)) * scale
        probs = _softmax_attend(scores, mask, dt)
        ctx = torch.einsum("bhts,bshv->bthv", probs, v)
        new_cache = {"ckv": ckv, "kr": kr} if return_cache else None
    out = torch.einsum("bthv,hvm->btm", ctx, p.wo.to(dt))
    return out, new_cache


# ---------------- public API ----------------

def init_attention(b: Builder, cfg: ModelConfig) -> nn.Module:
    return MLA(b, cfg) if cfg.attn == "mla" else Attention(b, cfg)


def attention(cfg: ModelConfig, p, x, cos, sin, rules: Rules,
              cache=None, cur_index=None, return_cache: bool = False):
    """Returns ``(out, new_cache)``. ``cache`` given => decode (T == 1);
    ``return_cache`` => prefill (the cache is built from this forward)."""
    fn = _mla if cfg.attn == "mla" else _gqa
    return fn(cfg, p, x, cos, sin, rules, cache, cur_index, return_cache)


def init_attn_cache(cfg: ModelConfig, batch: int, seq: int, dtype):
    """Per-layer cache shapes and dtypes (without the layer axis)."""
    if cfg.attn == "mla":
        m = cfg.mla
        return {"ckv": ((batch, seq, m.kv_lora), dtype),
                "kr": ((batch, seq, m.qk_rope), dtype)}
    return {
        "k": ((batch, seq, cfg.n_kv_heads, cfg.head_dim), dtype),
        "v": ((batch, seq, cfg.n_kv_heads, cfg.head_dim), dtype),
    }
