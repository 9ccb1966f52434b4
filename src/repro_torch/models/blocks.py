"""Block-level composition — the counterpart of ``repro.models.blocks``:
the pre-norm transformer block (attention + MLP or MoE).

Mamba2 blocks and the Zamba2 shared-attention hybrid wait for ROADMAP A13.
"""

from __future__ import annotations

import torch
from torch import nn

from ..parallel.sharding import Rules, constrain
from .attention import Attention, attention
from .config import ModelConfig
from .layers import MLP, Norm, mlp, norm
from .moe import MoE, moe
from .param import Builder

__all__ = ["TransformerBlock", "init_transformer_block", "transformer_block"]


class TransformerBlock(nn.Module):
    """``ln1``, ``attn``, ``ln2`` and ``moe`` or ``mlp``. ``ffn``: 'dense'
    or 'moe'."""

    def __init__(self, b: Builder, cfg: ModelConfig, ffn: str,
                 d_ff: int | None = None):
        super().__init__()
        self.ln1 = Norm(b, cfg.d_model, cfg.norm_kind)
        self.attn = Attention(b, cfg)
        self.ln2 = Norm(b, cfg.d_model, cfg.norm_kind)
        if ffn == "moe":
            self.moe = MoE(b, cfg)
        else:
            self.mlp = MLP(b, cfg.d_model, d_ff or cfg.d_ff, cfg.mlp_gated)


init_transformer_block = TransformerBlock


def transformer_block(cfg: ModelConfig, p, x, cos, sin, rules: Rules,
                      cache=None, cur_index=None, return_cache=False,
                      sort_impl: str = "xla"):
    """Pre-norm residual block. Returns ``(x, new_cache, aux_loss)``."""
    h, new_cache = attention(
        cfg, p.attn, norm(p.ln1, x, cfg.norm_eps, cfg.norm_kind),
        cos, sin, rules, cache, cur_index, return_cache)
    x = x + h
    x = constrain(x, rules, "batch", "res_seq", "act_embed")
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h2 = norm(p.ln2, x, cfg.norm_eps, cfg.norm_kind)
    if hasattr(p, "moe"):
        h2, aux = moe(cfg, p.moe, h2, rules, sort_impl)
    else:
        h2 = mlp(p.mlp, h2, cfg.mlp_act, cfg.mlp_gated, rules)
    return x + h2, new_cache, aux
