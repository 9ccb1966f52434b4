"""Mamba2 (state-space duality) block — the counterpart of
``repro.models.ssm``: the chunked path at training and prefill, and the
O(1)-state recurrence at decode.

The chunked path is the SSD algorithm (arXiv:2405.21060): the sequence is
cut into chunks; within a chunk the output is a masked quadratic form
(attention-like), and a small recurrence over the chunk states carries the
SSM state across chunks. :func:`ssd_reference`, the naive O(T) recurrence,
is the test oracle it is held against.

Decode keeps a constant-size cache a layer: the last ``d_conv - 1``
pre-activation rows of the depthwise conv, and the ``(H, P, N)`` SSM state
in float32. A decode step writes both into the cache tensors *in place*
and returns them, as attention's decode does.

A right-padded prefill passes ``seq_mask``: at padded positions ``dt``
before the softplus is set to -30.0 (not to 0), so the state barely moves
there. The conv window the cache takes ends at each request's length by
the reference's ``dynamic_slice`` rule (:func:`_tail_starts`), which wraps
a negative start and clamps it — a prompt shorter than ``d_conv - 1``
takes rows of the batch's padding, as the reference does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.sharding import Rules, constrain, constrain_core
from .config import ModelConfig
from .param import Builder, ParamModule

__all__ = ["Mamba", "init_mamba", "mamba_train", "mamba_decode",
           "init_ssm_cache", "ssd_reference"]


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    nheads = d_inner // s.headdim
    conv_dim = d_inner + 2 * s.n_groups * s.d_state
    return d_inner, nheads, conv_dim


class Mamba(ParamModule):
    """Mamba2 mixer weights: ``w_in`` ``(d_model, 2*d_inner + 2*G*N + H)``
    (the order ``[z (gate), xBC (conv'd), dt]``), ``conv_w`` ``(d_conv,
    conv_dim)``, ``conv_b``, ``A_log``, ``D``, ``dt_bias`` ``(H,)``,
    ``norm_w`` ``(d_inner,)``, ``w_out`` ``(d_inner, d_model)``."""

    def __init__(self, b: Builder, cfg: ModelConfig):
        super().__init__()
        s = cfg.ssm
        d_inner, nheads, conv_dim = _dims(cfg)
        dm = cfg.d_model
        self.w_in = b.param((dm, 2 * d_inner + 2 * s.n_groups * s.d_state
                             + nheads), ("embed", "mlp"))
        self.conv_w = b.param((s.d_conv, conv_dim), ("conv", "mlp"),
                              scale=s.d_conv ** -0.5)
        self.conv_b = b.param((conv_dim,), ("mlp",), init="zeros")
        self.A_log = b.param((nheads,), ("state",), init="ssm_a")
        self.D = b.param((nheads,), ("state",), init="ones")
        self.dt_bias = b.param((nheads,), ("state",), init="zeros")
        self.norm_w = b.param((d_inner,), ("mlp",), init="ones")
        self.w_out = b.param((d_inner, dm), ("mlp", "embed"))


init_mamba = Mamba


def _split_proj(cfg, proj):
    s = cfg.ssm
    d_inner, nheads, _ = _dims(cfg)
    return torch.split(proj, [d_inner, d_inner + 2 * s.n_groups * s.d_state,
                              nheads], dim=-1)


def _split_xbc(cfg, xbc):
    s = cfg.ssm
    d_inner, _, _ = _dims(cfg)
    gn = s.n_groups * s.d_state
    return torch.split(xbc, [d_inner, gn, gn], dim=-1)


def _softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros((), device=x.device))


def _gated_norm(p, y, z, eps):
    y = y * F.silu(z.float()).to(y.dtype)
    dt = y.dtype
    yf = y.float()
    yf = yf * torch.rsqrt(torch.mean(yf * yf, dim=-1, keepdim=True) + eps)
    return (yf * p.norm_w.float()).to(dt)


def _pad_time(x, before: int = 0, after: int = 0):
    """``x`` with ``before`` and ``after`` zero rows on its time axis (dim
    1): ``F.pad``'s values, by a concatenation, since torch 2.11's DTensor
    cannot pad a sharded tensor (an ``IndexError`` in the redistribution
    it plans)."""
    def zeros(n):
        return torch.zeros(x.shape[:1] + (n,) + x.shape[2:], dtype=x.dtype,
                           device=x.device)
    return torch.cat(([zeros(before)] if before else []) + [x]
                     + ([zeros(after)] if after else []), dim=1)


def _causal_conv_train(p, xbc):
    """Depthwise causal conv over time. xbc ``(B, T, C)``; conv_w ``(K,
    C)``: K shifted multiply-adds, in the reference's order."""
    k, t = p.conv_w.shape[0], xbc.shape[1]
    pad = _pad_time(xbc, before=k - 1)
    out = torch.zeros_like(xbc)
    for i in range(k):
        out = out + pad[:, i:i + t, :] * p.conv_w[i]
    return F.silu(out + p.conv_b)


# ---------------- chunked SSD (training / prefill) ----------------

def _ssd_chunked(x, dt, A, B_, C_, chunk):
    """x ``(B, T, H, P)``; dt ``(B, T, H)`` after the softplus; A ``(H,)``
    negative; B_, C_ ``(B, T, G, N)``. ``T`` a multiple of ``chunk``.
    Returns y ``(B, T, H, P)`` and the final state ``(B, H, P, N)``."""
    b, t, h, p = x.shape
    g, n = B_.shape[2], B_.shape[3]
    if t % chunk:
        raise ValueError(f"sequence {t} is not a multiple of chunk {chunk}")
    nc, q = t // chunk, chunk
    hpg = h // g                                     # heads per group

    xc = x.reshape(b, nc, q, h, p)
    dtc = dt.reshape(b, nc, q, h)
    bc = B_.reshape(b, nc, q, g, n)
    cc = C_.reshape(b, nc, q, g, n)

    cs = torch.cumsum(dtc * A, dim=2)                # (b, nc, q, h)
    xdt = xc * dtc[..., None]
    b_heads = bc.repeat_interleave(hpg, dim=3)       # (b, nc, q, h, n)
    c_heads = cc.repeat_interleave(hpg, dim=3)

    # intra-chunk: the masked quadratic form. Mask BEFORE the exp: above
    # the diagonal cs[q] - cs[k] > 0 can overflow exp in float32.
    cb = torch.einsum("bcqhn,bckhn->bcqkh", c_heads, b_heads)
    diff = cs[:, :, :, None, :] - cs[:, :, None, :, :]   # (b, nc, q, k, h)
    lower = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    diff = diff.masked_fill(~lower[None, None, :, :, None], float("-inf"))
    y_intra = torch.einsum("bcqkh,bckhp->bcqhp", cb * torch.exp(diff), xdt)

    # chunk states: S_c = sum_k exp(cs[-1] - cs[k]) * B_k (x dt)_k
    decay_to_end = torch.exp(cs[:, :, -1:, :] - cs)
    s_c = torch.einsum("bcqhn,bcqhp->bchpn",
                       b_heads * decay_to_end[..., None], xdt)

    # the recurrence over chunk states; each chunk reads the state entering it
    chunk_decay = torch.exp(cs[:, :, -1, :])         # (b, nc, h)
    state = torch.zeros((b, h, p, n), dtype=x.dtype, device=x.device)
    s_prev = []
    for c in range(nc):
        s_prev.append(state)
        state = state * chunk_decay[:, c, :, None, None] + s_c[:, c]
    s_prev = torch.stack(s_prev, dim=1)              # (b, nc, h, p, n)

    y_inter = torch.einsum("bcqhn,bchpn->bcqhp",
                           c_heads * torch.exp(cs)[..., None], s_prev)
    return (y_intra + y_inter).reshape(b, t, h, p), state


def ssd_reference(x, dt, A, B_, C_):
    """The naive O(T) recurrence (the tests' oracle)."""
    b, t, h, p = x.shape
    g, n = B_.shape[2], B_.shape[3]
    b_heads = B_.repeat_interleave(h // g, dim=2)
    c_heads = C_.repeat_interleave(h // g, dim=2)
    state = torch.zeros((b, h, p, n), dtype=x.dtype, device=x.device)
    ys = []
    for i in range(t):
        dec = torch.exp(dt[:, i] * A)                # (b, h)
        state = state * dec[:, :, None, None] + torch.einsum(
            "bhn,bhp->bhpn", b_heads[:, i], x[:, i] * dt[:, i, :, None])
        ys.append(torch.einsum("bhn,bhpn->bhp", c_heads[:, i], state))
    return torch.stack(ys, dim=1), state


# ---------------- the public paths ----------------

def _tail_starts(lens, t: int, k: int):
    """The first row of each request's conv window, ``lens - (k-1)``, by
    ``jax.lax.dynamic_slice``'s rule: a negative start has ``t`` added,
    then the start is clamped into ``[0, t - (k-1)]``."""
    if t < k - 1:
        # the reference's slice of k-1 rows out of t raises here too
        raise ValueError(f"a masked prefill of {t} positions is shorter than "
                         f"the conv window's {k - 1} rows")
    start = lens - (k - 1)
    start = torch.where(start < 0, start + t, start)
    return start.clamp(0, t - (k - 1))


def mamba_train(cfg: ModelConfig, p, x, rules: Rules,
                return_cache: bool = False, seq_mask=None):
    """The full-sequence path: x ``(B, T, d_model)`` -> ``(y, cache |
    None)``. ``seq_mask`` ``(B, T)`` marks the valid positions of a
    right-padded prefill."""
    s = cfg.ssm
    d_inner, nheads, _ = _dims(cfg)
    dt_x = x.dtype
    bsz, t, _ = x.shape

    proj = x @ p.w_in.to(dt_x)
    z, xbc_raw, dt_raw = _split_proj(cfg, proj)
    if seq_mask is not None:
        dt_raw = torch.where(seq_mask[:, :, None] > 0, dt_raw, -30.0)
    xbc = _causal_conv_train(p, xbc_raw).to(dt_x)
    xs, bb, cc = _split_xbc(cfg, xbc)

    xh = xs.reshape(bsz, t, nheads, s.headdim)
    xh = constrain(xh, rules, "batch", "seq", "act_heads", None)
    bg = bb.reshape(bsz, t, s.n_groups, s.d_state)
    cg = cc.reshape(bsz, t, s.n_groups, s.d_state)
    dt_pos = _softplus(dt_raw.float() + p.dt_bias.float())
    a = -torch.exp(p.A_log.float())

    pad = (-t) % s.chunk
    if pad:
        xh, bg, cg, dt_pos = (_pad_time(t, after=pad)
                              for t in (xh, bg, cg, dt_pos))

    y, final_state = _ssd_chunked(
        *(constrain_core(t, rules) for t in (xh.float(), dt_pos)), a,
        *(constrain_core(t.float(), rules) for t in (bg, cg)), s.chunk)
    y = y[:, :t].to(dt_x) \
        + xh[:, :t].to(dt_x) * p.D.to(dt_x)[None, None, :, None]
    y = _gated_norm(p, y.reshape(bsz, t, d_inner), z, cfg.norm_eps)
    out = y @ p.w_out.to(dt_x)

    cache = None
    if return_cache:
        k = p.conv_w.shape[0]
        if seq_mask is not None:
            # the conv window ends at each request's length
            lens = seq_mask.to(torch.int64).sum(dim=1)
            rows = _tail_starts(lens, t, k)[:, None] \
                + torch.arange(k - 1, device=x.device)
            tail = torch.take_along_dim(xbc_raw, rows[:, :, None], dim=1)
        elif t >= k - 1:
            tail = xbc_raw[:, t - (k - 1):]
        else:
            tail = _pad_time(xbc_raw, before=k - 1 - t)
        cache = {"conv": tail.to(dt_x), "ssm": final_state.float()}
    return out, cache


def mamba_decode(cfg: ModelConfig, p, x, cache, rules: Rules):
    """The one-token recurrent path: x ``(B, 1, d_model)``; ``cache``
    ``{"conv": (B, K-1, C), "ssm": (B, H, P, N)}``, written in place and
    returned."""
    s = cfg.ssm
    d_inner, nheads, _ = _dims(cfg)
    dt_x = x.dtype
    bsz = x.shape[0]

    proj = x @ p.w_in.to(dt_x)
    z, xbc_new, dt_raw = _split_proj(cfg, proj)

    # the conv window: the cache's K-1 pre-activation rows and the new one
    window = torch.cat([cache["conv"], xbc_new], dim=1)        # (B, K, C)
    conv_out = torch.einsum("bkc,kc->bc", window, p.conv_w) + p.conv_b
    xbc = F.silu(conv_out)[:, None, :].to(dt_x)

    xs, bb, cc = _split_xbc(cfg, xbc)
    xh = xs.reshape(bsz, nheads, s.headdim)
    hpg = nheads // s.n_groups
    b_heads = bb.reshape(bsz, s.n_groups, s.d_state).repeat_interleave(
        hpg, dim=1).float()
    c_heads = cc.reshape(bsz, s.n_groups, s.d_state).repeat_interleave(
        hpg, dim=1).float()

    dt_pos = _softplus(dt_raw[:, 0].float() + p.dt_bias.float())
    dec = torch.exp(dt_pos * -torch.exp(p.A_log.float()))      # (B, H)
    state = cache["ssm"] * dec[:, :, None, None] + torch.einsum(
        "bhn,bhp->bhpn", *(constrain_core(t, rules) for t in (
            b_heads, xh.float() * dt_pos[..., None])))
    y = torch.einsum("bhn,bhpn->bhp", *(constrain_core(t, rules) for t in (
        c_heads, state))).to(dt_x)
    y = y + xh * p.D.to(dt_x)[None, :, None]
    y = _gated_norm(p, y.reshape(bsz, 1, d_inner), z, cfg.norm_eps)
    out = y @ p.w_out.to(dt_x)
    cache["conv"].copy_(window[:, 1:])
    cache["ssm"].copy_(state)
    return out, cache


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype):
    """Per-layer decode cache shapes and dtypes (constant in context
    length)."""
    s = cfg.ssm
    _, nheads, conv_dim = _dims(cfg)
    return {
        "conv": ((batch, s.d_conv - 1, conv_dim), dtype),
        "ssm": ((batch, nheads, s.headdim, s.d_state), torch.float32),
    }
