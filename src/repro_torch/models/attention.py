"""Attention — the counterpart of ``repro.models.attention``: grouped-query
attention (GQA; llama3, glm4, nemotron, granite, ...) with its training,
prefill (cache-building) and decode (cache-consuming) paths.

The math stays in the reference's plain ops — einsums and a masked softmax
in float32 — so both packages compute the same numbers; no kernel computes
it, and ``scaled_dot_product_attention`` would change them. Masked scores
take ``finfo(float32).min``, not ``-inf``; the streaming path
(:func:`_gqa_chunked`) uses ``-inf`` with a finite guard, as the reference
does.

Multi-head latent attention (MLA: minicpm3, deepseek-v2) waits for ROADMAP
A13 and raises ``NotImplementedError``.

A decode step writes the new entry into the cache tensors *in place* and
returns them: the caller's cache is the step's cache. Rows whose index is
past the cache are not written, as in the reference's per-row write.
"""

from __future__ import annotations

import torch
from torch import nn

from ..parallel.sharding import Rules, constrain
from .config import ModelConfig
from .layers import apply_rope
from .param import Builder

__all__ = ["Attention", "init_attention", "attention", "init_attn_cache",
           "check_attention"]

_NEG = torch.finfo(torch.float32).min


def check_attention(cfg: ModelConfig):
    """Raise for the attention families the port has not ported."""
    if cfg.attn == "mla":
        raise NotImplementedError(
            f"{cfg.name}: multi-head latent attention (MLA) is not ported "
            "yet (ROADMAP A13)")


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
    select)."""
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


class Attention(nn.Module):
    """GQA weights: ``wq`` ``(d_model, heads, head_dim)``, ``wk``/``wv``
    ``(d_model, kv_heads, head_dim)``, ``wo`` ``(heads, head_dim,
    d_model)``."""

    def __init__(self, b: Builder, cfg: ModelConfig):
        super().__init__()
        check_attention(cfg)
        dm, h, k, d = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        self.wq = b.param((dm, h, d))
        self.wk = b.param((dm, k, d))
        self.wv = b.param((dm, k, d))
        self.wo = b.param((h, d, dm))


init_attention = Attention


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

    qg = q.reshape(B, T, kh, g, d)
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
    out = torch.einsum("bthd,hdm->btm", ctx, p.wo.to(dt))
    return out, new_cache


def attention(cfg: ModelConfig, p, x, cos, sin, rules: Rules,
              cache=None, cur_index=None, return_cache: bool = False):
    """Returns ``(out, new_cache)``. ``cache`` given => decode (T == 1);
    ``return_cache`` => prefill (the cache is built from this forward)."""
    check_attention(cfg)
    return _gqa(cfg, p, x, cos, sin, rules, cache, cur_index, return_cache)


def init_attn_cache(cfg: ModelConfig, batch: int, seq: int, dtype):
    """Per-layer cache shapes and dtypes (without the layer axis)."""
    check_attention(cfg)
    return {
        "k": ((batch, seq, cfg.n_kv_heads, cfg.head_dim), dtype),
        "v": ((batch, seq, cfg.n_kv_heads, cfg.head_dim), dtype),
    }
