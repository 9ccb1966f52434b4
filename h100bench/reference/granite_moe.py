"""The plain reference of the served Granite-MoE: a float32 forward of a
GQA transformer whose every layer is a top-k mixture of experts, written
from the configuration alone with plain ``torch`` operations (no kernel of
the port, no cache manager, TF32 off).

It follows the served semantics a batch at a time, because the published
capacity rule couples a batch's tokens: an expert takes at most
``capacity = int(capacity_factor * tokens * top_k / n_experts)`` rounded up
to a multiple of 8 (at least 8) of the batch's assignments, taken in
token-major order, padding positions included, and drops the rest. So:

* :meth:`Plain.prefill` runs the batch's right-padded prompts (pad id 0)
  through every layer (causal attention, pre-norm RMSNorm, RoPE with the
  half-split convention, softmax routing over all experts, the top-k
  renormalised, the capacity rule over all ``B * T`` tokens) and returns the
  logits of each prompt's last real position and each row's keys and
  values;
* :meth:`Plain.decode` takes one token a row at the row's own position,
  attends the row's prompt and earlier steps, applies the capacity rule over
  the batch's ``B`` tokens, and returns the logits.

``precision='fp8'`` is the check's control: every projection's operands
(weights per tensor, activations per row) rounded to float8 e4m3 before the
float32 product, the step below the configuration's bfloat16.
"""

from __future__ import annotations

import contextlib
import math

import torch

_F8_MAX = 448.0


@contextlib.contextmanager
def exact_float32():
    """TF32 off for matmuls and convolutions, restored on exit."""
    m, c = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    prec = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c
        torch.set_float32_matmul_precision(prec)


def _fp8(x: torch.Tensor, dim=None) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a scale that maps its largest
    magnitude (over ``dim``, or the whole tensor) to 448."""
    amax = x.abs().amax() if dim is None else x.abs().amax(dim=dim,
                                                            keepdim=True)
    scale = torch.clamp(amax, min=1e-30) / _F8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def capacity(cap_factor: float, tokens: int, top_k: int, n_experts: int):
    c = int(cap_factor * tokens * top_k / n_experts)
    return max(8, -(-c // 8) * 8)


class Plain:
    """``weights``: ``{name: tensor}`` in the port's parameter names (any
    dtype; each is taken to float32 where used); ``model``: the
    configuration's ``model`` section."""

    def __init__(self, model: dict, weights: dict, precision: str = "fp32"):
        if precision not in ("fp32", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.m = model
        self.w = weights
        self.fp8 = precision == "fp8"

    # ---- pieces ----
    def _weight(self, name, per=None):
        w = self.w[name].float()
        if self.fp8:
            w = _fp8(w) if per is None else _fp8(w, dim=per)
        return w

    def _act(self, x):
        return _fp8(x, dim=-1) if self.fp8 else x

    def _norm(self, x, name):
        x = x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + self.m["norm_eps"])
        return x * self.w[name].float()

    def _rope(self, x, pos):
        """x ``(..., S, H, D)``, pos ``(..., S)``: the half-split rotation of
        all of ``D`` by ``pos * theta ** (-i / (D / 2))``."""
        d = x.shape[-1]
        half = d // 2
        freq = self.m["rope_theta"] ** (
            -torch.arange(half, dtype=torch.float32, device=x.device) / half)
        ang = pos.float()[..., None] * freq
        c, s = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)

    def _proj(self, x, name):
        """``x (..., d_in) @ W`` with ``W`` flattened to ``(d_in, -1)``."""
        w = self._weight(name)
        return self._act(x) @ w.reshape(w.shape[0], -1)

    def _qkv(self, x, i, pos):
        m, p = self.m, f"blocks.{i}.attn."
        lead = x.shape[:-1]
        q = self._proj(x, p + "wq").reshape(*lead, m["n_heads"], m["head_dim"])
        k = self._proj(x, p + "wk").reshape(*lead, m["n_kv_heads"],
                                            m["head_dim"])
        v = self._proj(x, p + "wv").reshape(*lead, m["n_kv_heads"],
                                            m["head_dim"])
        return self._rope(q, pos), self._rope(k, pos), v

    def _attend(self, q, k, v, mask):
        """q ``(T, H, D)``, k/v ``(S, KH, D)``, mask ``(T, S)`` -> ``(T, H*D)``."""
        g = q.shape[1] // k.shape[1]
        k = k.repeat_interleave(g, dim=1)
        v = v.repeat_interleave(g, dim=1)
        s = torch.einsum("thd,shd->hts", q, k) / math.sqrt(q.shape[-1])
        s = s.masked_fill(~mask, float("-inf"))
        ctx = torch.einsum("hts,shd->thd", torch.softmax(s, dim=-1), v)
        return ctx.reshape(q.shape[0], -1)

    def _out(self, ctx, i):
        w = self._weight(f"blocks.{i}.attn.wo")
        return self._act(ctx) @ w.reshape(-1, w.shape[-1])

    def _moe(self, x, i):
        """x ``(t, d)`` -> ``(t, d)``: route, drop past capacity, run the
        experts, combine."""
        m, p = self.m, f"blocks.{i}.moe."
        moe = m["moe"]
        e, k = moe["n_experts"], moe["top_k"]
        t = x.shape[0]
        probs = torch.softmax(self._act(x) @ self._weight(p + "router"),
                              dim=-1)
        top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
        top_p, top_e = top_p[:, :k], top_e[:, :k]
        if moe.get("router_renorm", True):
            top_p = top_p / top_p.sum(-1, keepdim=True)
        cap = capacity(moe["capacity_factor"], t, k, e)
        flat_e = top_e.reshape(-1)
        order = torch.argsort(flat_e, stable=True)      # token-major in each
        sorted_e = flat_e[order]
        counts = torch.bincount(flat_e, minlength=e)
        rank = torch.arange(t * k, device=x.device) - \
            (torch.cumsum(counts, 0) - counts)[sorted_e]
        keep = rank < cap
        tok = order[keep] // k
        ex, slot = sorted_e[keep], rank[keep]
        buf = x.new_zeros((e, cap, x.shape[1]))
        buf[ex, slot] = x[tok]
        w_in = self._weight(p + "w_in", per=(1, 2))
        w_out = self._weight(p + "w_out", per=(1, 2))
        h = torch.bmm(self._act(buf), w_in)
        u, gate = torch.chunk(h, 2, dim=-1) if m["mlp_gated"] else (h, None)
        h = u * torch.nn.functional.silu(gate) if gate is not None else \
            torch.nn.functional.silu(u)
        out = torch.bmm(self._act(h), w_out)
        y = torch.zeros_like(x)
        y.index_add_(0, tok, out[ex, slot] * top_p.reshape(-1)[order[keep],
                                                               None])
        return y

    def _head(self, x):
        x = self._norm(x, "final_norm.w")
        w = self._weight("embed").T if self.m.get("tie_embeddings") else \
            self._weight("head")
        return self._act(x) @ w

    # ---- the served batch ----
    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, lengths: torch.Tensor):
        """tokens ``(B, T)`` right-padded, lengths ``(B,)`` -> (logits of
        each row's last real position ``(B, V)``, ``[(k, v)]`` a layer,
        each ``(B, T, KH, D)``)."""
        b, t = tokens.shape
        x = self.w["embed"].float()[tokens]
        pos = torch.arange(t, device=tokens.device)
        causal = pos[:, None] >= pos[None, :]
        cache = []
        for i in range(self.m["n_layers"]):
            h = self._norm(x, f"blocks.{i}.ln1.w")
            q, k, v = self._qkv(h, i, pos.expand(b, t))
            ctx = torch.stack([self._attend(q[r], k[r], v[r], causal)
                               for r in range(b)])
            x = x + self._out(ctx, i)
            h = self._norm(x, f"blocks.{i}.ln2.w")
            x = x + self._moe(h.reshape(b * t, -1), i).reshape(b, t, -1)
            cache.append((k, v))
        last = x[torch.arange(b, device=x.device), lengths - 1]
        return self._head(last), cache

    @torch.no_grad()
    def decode(self, cache, tok: torch.Tensor, cur: torch.Tensor):
        """One token a row (``tok`` ``(B,)``) at position ``cur`` ``(B,)``
        against ``cache`` (grown and written in place) -> logits ``(B, V)``."""
        b = tok.shape[0]
        x = self.w["embed"].float()[tok]
        rows = torch.arange(b, device=tok.device)
        for i in range(self.m["n_layers"]):
            kc, vc = cache[i]
            need = int(cur.max()) + 1
            if kc.shape[1] < need:
                grow = need - kc.shape[1]
                kc = torch.cat([kc, kc.new_zeros((b, grow, *kc.shape[2:]))], 1)
                vc = torch.cat([vc, vc.new_zeros((b, grow, *vc.shape[2:]))], 1)
            h = self._norm(x, f"blocks.{i}.ln1.w")
            q, k, v = self._qkv(h[:, None], i, cur[:, None])
            kc[rows, cur] = k[:, 0]
            vc[rows, cur] = v[:, 0]
            cache[i] = (kc, vc)
            pos = torch.arange(kc.shape[1], device=tok.device)
            ctx = torch.stack([self._attend(q[r], kc[r], vc[r],
                                            (pos <= cur[r])[None, :])
                               for r in range(b)])
            x = x + self._out(ctx[:, 0], i)
            x = x + self._moe(self._norm(x, f"blocks.{i}.ln2.w"), i)
        return self._head(x)
