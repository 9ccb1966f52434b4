"""Shared primitive layers — the counterpart of ``repro.models.layers``:
norms, rotary embeddings (RoPE, M-RoPE, partial) and dense MLPs.

Each layer is a plain function on tensors (the reference's, op for op) and
an ``nn.Module`` that holds its weights under the reference's names, so a
module's ``state_dict`` keys are the reference's parameter paths.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.sharding import Rules, constrain
from .param import Builder, ParamModule

__all__ = [
    "rmsnorm", "layernorm", "norm", "Norm", "init_norm",
    "rope_angles", "apply_rope", "mrope_angles",
    "MLP", "init_mlp", "mlp", "ACTS",
]


# ---------------- norms ----------------

class Norm(ParamModule):
    """RMSNorm (``w``) or LayerNorm (``w``, ``b``) weights."""

    def __init__(self, b: Builder, d: int, kind: str = "rmsnorm"):
        super().__init__()
        self.w = b.param((d,), ("act_embed",), init="ones")
        if kind == "layernorm":
            self.b = b.param((d,), ("act_embed",), init="zeros")


init_norm = Norm


def rmsnorm(p, x, eps: float):
    """Computed in float32, cast back to ``x``'s dtype."""
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * p.w.float()).to(dt)


def layernorm(p, x, eps: float):
    """Computed in float32, cast back to ``x``'s dtype."""
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    b = getattr(p, "b", None)
    return (x * p.w.float() + (0.0 if b is None else b)).to(dt)


def norm(p, x, eps: float, kind: str):
    return rmsnorm(p, x, eps) if kind == "rmsnorm" else layernorm(p, x, eps)


# ---------------- rotary embeddings ----------------

def _freq(half: int, theta: float, device) -> torch.Tensor:
    return theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=device) / half)


def rope_angles(positions, rot_dim: int, theta: float):
    """positions ``(...,)`` -> cos, sin ``(..., rot_dim//2)``, float32."""
    ang = positions[..., None].float() * _freq(rot_dim // 2, theta,
                                               positions.device)
    return torch.cos(ang), torch.sin(ang)


def mrope_angles(positions, rot_dim: int, theta: float, sections):
    """Multimodal RoPE (qwen2-vl): positions ``(B, S, 3)`` = (t, h, w) ids.
    The ``rot_dim//2`` frequency slots are split into ``sections`` (t/h/w);
    each takes its angle from the matching position channel."""
    half = rot_dim // 2
    if sum(sections) != half:
        raise ValueError(f"mrope sections {sections} must sum to {half}")
    ang_all = positions[..., None].float() * _freq(half, theta,
                                                   positions.device)
    parts, start = [], 0
    for ch, width in enumerate(sections):
        parts.append(ang_all[..., ch, start:start + width])
        start += width
    ang = torch.cat(parts, dim=-1)                      # (B, S, half)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin, rope_pct: float = 1.0):
    """x ``(..., S, H, D)``; cos/sin ``(..., S, half)``. Half-split (NeoX)
    convention; ``rope_pct < 1`` rotates only the leading fraction of D
    (glm4)."""
    d = x.shape[-1]
    rot = int(d * rope_pct)
    rot -= rot % 2
    xr, xp = x[..., :rot], x[..., rot:]
    half = rot // 2
    x1, x2 = xr[..., :half].float(), xr[..., half:].float()
    c = cos[..., None, :half].float()
    s = sin[..., None, :half].float()
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return torch.cat([out.to(x.dtype), xp], dim=-1)


# ---------------- dense MLP ----------------

def _relu2(x):
    return torch.square(torch.relu(x))       # nemotron-4 squared ReLU


ACTS = {
    "silu": F.silu,
    # jax.nn.gelu's default is the tanh approximation
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "relu2": _relu2,
}


class MLP(ParamModule):
    """Dense MLP weights: ``w_in`` ``(d_model, 2*d_ff | d_ff)``, ``w_out``
    ``(d_ff, d_model)``."""

    def __init__(self, b: Builder, d_model: int, d_ff: int, gated: bool):
        super().__init__()
        self.w_in = b.param((d_model, 2 * d_ff if gated else d_ff),
                            ("embed", "mlp"))
        self.w_out = b.param((d_ff, d_model), ("mlp", "embed"))


init_mlp = MLP


def mlp(p, x, act: str, gated: bool, rules: Rules):
    """``x @ w_in``, then ``u * act(g)`` for a gated MLP — the first half
    ``u`` is the value, the second ``g`` the gate — or ``act(h)``, then
    ``@ w_out``."""
    h = x @ p.w_in.to(x.dtype)
    if gated:
        u, g = torch.chunk(h, 2, dim=-1)
        h = u * ACTS[act](g)
    else:
        h = ACTS[act](h)
    h = constrain(h, rules, "batch", "seq", "act_mlp")
    return h @ p.w_out.to(x.dtype)
