"""Block-level composition — the counterpart of ``repro.models.blocks``:
the pre-norm transformer block (GQA or MLA attention, then an MLP or MoE)
and the Mamba2 block (norm, mixer, residual)."""

from __future__ import annotations

import torch
from torch import nn

from ..parallel.sharding import Rules, constrain
from .attention import attention, init_attention
from .config import ModelConfig
from .layers import MLP, Norm, mlp, norm
from .moe import MoE, moe
from .param import Builder
from .ssm import Mamba, mamba_decode, mamba_train

__all__ = ["TransformerBlock", "init_transformer_block", "transformer_block",
           "MambaBlock", "init_mamba_block", "mamba_block"]


class TransformerBlock(nn.Module):
    """``ln1``, ``attn``, ``ln2`` and ``moe`` or ``mlp``. ``ffn``: 'dense'
    or 'moe'."""

    def __init__(self, b: Builder, cfg: ModelConfig, ffn: str,
                 d_ff: int | None = None):
        super().__init__()
        self.ln1 = Norm(b, cfg.d_model, cfg.norm_kind)
        self.attn = init_attention(b, cfg)
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


class MambaBlock(nn.Module):
    """``ln`` and the Mamba2 ``mixer``."""

    def __init__(self, b: Builder, cfg: ModelConfig):
        super().__init__()
        self.ln = Norm(b, cfg.d_model, cfg.norm_kind)
        self.mixer = Mamba(b, cfg)


init_mamba_block = MambaBlock


def mamba_block(cfg: ModelConfig, p, x, rules: Rules, cache=None,
                return_cache=False, seq_mask=None):
    """Pre-norm residual Mamba2 block. Returns ``(x, new_cache)``."""
    h = norm(p.ln, x, cfg.norm_eps, cfg.norm_kind)
    if cache is not None:
        h, new_cache = mamba_decode(cfg, p.mixer, h, cache, rules)
    else:
        h, new_cache = mamba_train(cfg, p.mixer, h, rules, return_cache,
                                   seq_mask)
    return x + h, new_cache
