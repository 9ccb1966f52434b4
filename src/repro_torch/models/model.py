"""LM assembly — the counterpart of ``repro.models.model``: parameter init,
the full-sequence forward (training loss, prefill) and single-token decode.

:class:`LM` is an ``nn.Module`` that holds one :class:`TransformerBlock` a
layer in ``ModuleList``s named as the reference's stacks ('first' for the
leading dense layers of an MoE model, 'blocks'), so ``lm.blocks[i]``'s
weights are layer ``i`` of the reference's stacked ``params["blocks"]``.
The reference's functions (``init_lm``, ``forward``, ``decode_step``,
``init_cache``, ``lm_loss``, ``default_positions``) stay as thin functions
over it, where the reference's ``params`` argument is the ``LM``. Where the
reference scans a stack, the port loops over its blocks.

The ported families: every token or frames architecture with GQA
attention — dense, MoE, vlm and audio. MLA, SSM and the SSM hybrid raise
``NotImplementedError`` naming ROADMAP A13 at ``init_lm``, ``forward``,
``decode_step`` and ``init_cache``; ``remat`` is accepted and has no
effect (there is no backward pass without training, which comes later).

The decode cache is ``{stack: {"k": (n_layers, B, S, kv_heads, head_dim),
"v": ...}}``, the reference's layout, and a decode step writes its entry
into it in place.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from ..interop import resolve_device
from ..parallel.sharding import Rules, constrain
from .attention import check_attention, init_attn_cache
from .blocks import TransformerBlock, transformer_block
from .config import ModelConfig
from .layers import Norm, mrope_angles, norm, rope_angles
from .param import Builder

__all__ = [
    "LM", "init_lm", "forward", "lm_loss", "decode_step", "init_cache",
    "default_positions", "check_family",
]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def _dtype(name: str):
    return _DTYPES[name]


def check_family(cfg: ModelConfig):
    """Raise ``NotImplementedError`` for a family the port has not ported
    (MLA attention, SSM, the SSM hybrid: ROADMAP A13)."""
    if cfg.family in ("ssm", "hybrid"):
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family (Mamba2 blocks) is not "
            "ported yet (ROADMAP A13)")
    check_attention(cfg)


def _plan(cfg: ModelConfig):
    """``[(stack_name, n_layers, kind)]``, kind 'dense' or 'moe'."""
    check_family(cfg)
    if cfg.family in ("dense", "vlm", "audio"):
        return [("blocks", cfg.n_layers, "dense")]
    if cfg.family == "moe":
        fd = cfg.moe.first_dense
        plan = [("first", fd, "dense")] if fd else []
        return plan + [("blocks", cfg.n_layers - fd, "moe")]
    raise ValueError(f"unknown family {cfg.family!r}")


class LM(nn.Module):
    """The weights of a language model: ``embed`` (token archs),
    one ``ModuleList`` of blocks a stack, ``final_norm`` and ``head``
    (unless the embeddings are tied)."""

    def __init__(self, cfg: ModelConfig, b: Builder):
        super().__init__()
        if cfg.input_kind == "tokens":
            self.embed = b.param((cfg.vocab_size, cfg.d_model),
                                 scale=cfg.d_model ** -0.5)
        for name, n, kind in _plan(cfg):
            if kind == "moe":
                blocks = [TransformerBlock(b, cfg, ffn="moe")
                          for _ in range(n)]
            else:
                d_ff = (cfg.moe.dense_d_ff if cfg.family == "moe"
                        and cfg.moe.dense_d_ff else cfg.d_ff)
                blocks = [TransformerBlock(b, cfg, ffn="dense", d_ff=d_ff)
                          for _ in range(n)]
            setattr(self, name, nn.ModuleList(blocks))
        self.final_norm = Norm(b, cfg.d_model, cfg.norm_kind)
        if not cfg.tie_embeddings:
            self.head = b.param((cfg.d_model, cfg.vocab_size))

    @property
    def device(self) -> torch.device:
        return self.final_norm.w.device


# ---------------- init ----------------

def init_lm(cfg: ModelConfig, seed: int = 0, device="cuda") -> LM:
    """An :class:`LM` of ``cfg`` on ``device`` in ``cfg.param_dtype``,
    drawn from a ``torch.Generator`` on ``device`` seeded with ``seed``.
    The default device is the card, and it raises where there is none;
    ``device='meta'`` allocates nothing."""
    check_family(cfg)
    dev = resolve_device(device)
    gen = None if dev.type == "meta" else \
        torch.Generator(device=dev).manual_seed(seed)
    return LM(cfg, Builder(gen, dtype=_dtype(cfg.param_dtype), device=dev))


# ---------------- shared helpers ----------------

def default_positions(cfg: ModelConfig, batch: int, seq: int, offset=0,
                      device="cpu"):
    """Positions ``(batch, seq)`` from ``offset`` (a scalar, or ``(batch,)``
    per request); ``(batch, seq, 3)`` for M-RoPE (text: t = h = w)."""
    off = torch.as_tensor(offset, dtype=torch.int32, device=device)
    if off.dim() == 1:
        off = off[:, None]
    pos = torch.arange(seq, dtype=torch.int32, device=device)[None, :] + off
    pos = pos.expand(batch, seq)
    if cfg.rope_kind == "mrope":
        return pos[:, :, None].expand(batch, seq, 3)
    return pos


def _rope(cfg: ModelConfig, positions):
    rot = int(cfg.head_dim * cfg.rope_pct)
    rot -= rot % 2
    if cfg.rope_kind == "none":
        # degenerate angles: the identity rotation
        z = torch.zeros(positions.shape[:2] + (rot // 2,),
                        device=positions.device)
        return torch.cos(z), torch.sin(z)
    if cfg.rope_kind == "mrope":
        return mrope_angles(positions, rot, cfg.rope_theta,
                            cfg.mrope_sections)
    return rope_angles(positions, rot, cfg.rope_theta)


def _as(x, device, dtype=None):
    t = torch.as_tensor(x, device=device)
    return t if dtype is None else t.to(dtype)


def _embed(cfg, params, batch, rules: Rules):
    dev = params.device
    if cfg.input_kind == "tokens":
        x = params.embed[_as(batch["tokens"], dev, torch.long)]
    else:
        x = _as(batch["frames"], dev)
    x = x.to(_dtype(cfg.compute_dtype))
    return constrain(x, rules, "batch", "res_seq", "act_embed")


def _head(cfg, params, x, rules: Rules):
    x = norm(params.final_norm, x, cfg.norm_eps, cfg.norm_kind)
    w = params.embed.T if cfg.tie_embeddings else params.head
    logits = x @ w.to(x.dtype)
    return constrain(logits, rules, "batch", "seq", "act_vocab")


def _check_remat(remat: str):
    if remat not in ("none", "full", "dots"):
        raise ValueError(f"unknown remat {remat!r}")


# ---------------- forward (train / prefill) ----------------

def forward(cfg: ModelConfig, params: LM, batch, rules: Rules,
            sort_impl: str = "xla", return_cache: bool = False,
            remat: Optional[str] = None):
    """Full-sequence forward. ``batch``: ``tokens`` ``(B, S)`` or
    ``frames`` ``(B, S, d)``, optional ``positions``. Returns ``(logits,
    aux_loss, cache | None)``."""
    check_family(cfg)
    _check_remat(cfg.remat if remat is None else remat)
    x = _embed(cfg, params, batch, rules)
    bsz, seq = x.shape[:2]
    positions = batch.get("positions")
    positions = (default_positions(cfg, bsz, seq, device=x.device)
                 if positions is None else _as(positions, x.device))
    cos, sin = _rope(cfg, positions)

    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    caches: Dict[str, Any] = {}
    for name, _, _ in _plan(cfg):
        ks, vs = [], []
        for block in getattr(params, name):
            x, c, aux = transformer_block(
                cfg, block, x, cos, sin, rules, return_cache=return_cache,
                sort_impl=sort_impl)
            aux_total = aux_total + aux
            if return_cache:
                ks.append(c["k"])
                vs.append(c["v"])
        if return_cache:
            caches[name] = {"k": torch.stack(ks), "v": torch.stack(vs)}

    logits = _head(cfg, params, x, rules)
    return logits, aux_total, (caches if return_cache else None)


# ---------------- loss ----------------

def lm_loss(cfg: ModelConfig, params: LM, batch, rules: Rules,
            sort_impl: str = "xla"):
    """Mean next-token cross entropy (labels < 0 masked) + MoE aux.
    Returns ``(loss, {"ce", "aux"})``."""
    logits, aux, _ = forward(cfg, params, batch, rules, sort_impl=sort_impl)
    labels = _as(batch["labels"], logits.device, torch.long)
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    ll = torch.take_along_dim(lf, labels.clamp(min=0)[..., None],
                              dim=-1)[..., 0]
    mask = (labels >= 0).float()
    ce = torch.sum((lse - ll) * mask) / torch.clamp(mask.sum(), min=1.0)
    return ce + aux, {"ce": ce, "aux": aux}


# ---------------- decode ----------------

def decode_step(cfg: ModelConfig, params: LM, cache, tokens_or_frames,
                cur_index, rules: Rules, sort_impl: str = "xla"):
    """One-token decode against ``cache`` (written in place). ``cur_index``:
    the position of the new token, a scalar or ``(B,)``. Returns ``(logits
    (B, 1, V), cache)``."""
    check_family(cfg)
    key = "tokens" if cfg.input_kind == "tokens" else "frames"
    x = _embed(cfg, params, {key: tokens_or_frames}, rules)
    bsz = x.shape[0]
    cur = _as(cur_index, x.device)
    positions = default_positions(cfg, bsz, 1, offset=cur, device=x.device)
    cos, sin = _rope(cfg, positions)

    for name, _, _ in _plan(cfg):
        stack = cache[name]
        for i, block in enumerate(getattr(params, name)):
            layer = {"k": stack["k"][i], "v": stack["v"][i]}
            x, _, _ = transformer_block(cfg, block, x, cos, sin, rules,
                                        cache=layer, cur_index=cur,
                                        sort_impl=sort_impl)

    return _head(cfg, params, x, rules), cache


# ---------------- cache construction ----------------

_CACHE_AXES = ("layers", "cache_batch", "cache_seq", "cache_kv_heads", None)


def init_cache(cfg: ModelConfig, batch: int, seq: int,
               abstract: bool = False, device="cuda"):
    """The zeroed decode cache of ``seq`` positions and its logical axes:
    ``(cache, axes)``. ``abstract=True`` builds it on the ``meta`` device,
    allocating nothing."""
    check_family(cfg)
    dev = torch.device("meta") if abstract else resolve_device(device)
    dtype = _dtype(cfg.compute_dtype)
    cache, axes = {}, {}
    for name, n, _ in _plan(cfg):
        spec = init_attn_cache(cfg, batch, seq, dtype)
        cache[name] = {k: torch.zeros((n,) + shape, dtype=dt, device=dev)
                       for k, (shape, dt) in spec.items()}
        axes[name] = {k: _CACHE_AXES for k in spec}
    return cache, axes
