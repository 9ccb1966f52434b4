"""LM assembly — the counterpart of ``repro.models.model``: parameter init,
the full-sequence forward (training loss, prefill) and single-token decode,
for every family of the architecture pool.

:class:`LM` is an ``nn.Module`` that holds one block a layer in
``ModuleList``s named as the reference's stacks ('first' for the leading
dense layers of an MoE model, 'blocks'), so ``lm.blocks[i]``'s weights are
layer ``i`` of the reference's stacked ``params["blocks"]``. The hybrid
(zamba2) also holds ``shared``, one transformer block (one set of weights)
applied before every group of ``hybrid_period`` Mamba2 layers
(:func:`hybrid_groups`), each application with its own KV cache. The
reference's functions (``init_lm``, ``forward``, ``decode_step``,
``init_cache``, ``lm_loss``, ``default_positions``) stay as thin functions
over it, where the reference's ``params`` argument is the ``LM``. Where
the reference scans a stack, the port loops over its blocks.

``remat`` (the config's, or the argument) is the reference's
``_maybe_remat`` around each block of a stack (the hybrid's Mamba2 layers,
not its shared block), where autograd records the forward: 'full' keeps
only each block's input (``torch.utils.checkpoint``, non-reentrant) and
runs the block again in the backward pass; 'dots' — the reference's
``dots_with_no_batch_dims_saveable`` — keeps the products with no batch
dimension (``aten.mm``, ``aten.addmm``) and recomputes everything else,
the batched products (``bmm``: the attention einsums, the experts) among
them (selective activation checkpointing). The recompute runs the MoE
dispatch's sort again; the sort is deterministic, so it gives the first
pass's permutation. Under ``no_grad`` or ``inference_mode`` (serving)
``remat`` changes nothing.

The decode cache is the reference's layout — ``{stack: {"k", "v"}}`` for
GQA, ``{"ckv", "kr"}`` for MLA, ``{"conv", "ssm"}`` for Mamba2, each leaf
with a leading layer axis; the hybrid's ``{"shared": {"k", "v"}, "blocks":
{"conv", "ssm"}}`` — and a decode step writes its entries into it in
place.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..interop import resolve_device
from ..parallel.compat import get_mesh, set_mesh
from ..parallel.sharding import Rules, constrain, mesh_inputs
from ..runtime import trace
from .attention import init_attn_cache
from .blocks import (MambaBlock, TransformerBlock, mamba_block,
                     transformer_block)
from .config import ModelConfig
from .layers import Norm, mrope_angles, norm, rope_angles
from .param import Builder, ParamModule
from .ssm import init_ssm_cache

__all__ = [
    "LM", "init_lm", "forward", "lm_loss", "decode_step", "init_cache",
    "default_positions", "hybrid_groups",
]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def _dtype(name: str):
    return _DTYPES[name]


def hybrid_groups(cfg: ModelConfig):
    """``[(start, end)]`` Mamba2-layer slices; the shared block precedes
    each."""
    period = cfg.hybrid_period
    return [(s, min(s + period, cfg.n_layers))
            for s in range(0, cfg.n_layers, period)]


def _plan(cfg: ModelConfig):
    """``[(stack_name, n_layers, kind)]``, kind 'dense', 'moe' or
    'mamba'."""
    if cfg.family in ("dense", "vlm", "audio"):
        return [("blocks", cfg.n_layers, "dense")]
    if cfg.family == "moe":
        fd = cfg.moe.first_dense
        plan = [("first", fd, "dense")] if fd else []
        return plan + [("blocks", cfg.n_layers - fd, "moe")]
    if cfg.family in ("ssm", "hybrid"):
        return [("blocks", cfg.n_layers, "mamba")]
    raise ValueError(f"unknown family {cfg.family!r}")


class LM(ParamModule):
    """The weights of a language model: ``embed`` (token archs),
    one ``ModuleList`` of blocks a stack, the hybrid's ``shared`` block,
    ``final_norm`` and ``head`` (unless the embeddings are tied)."""

    def __init__(self, cfg: ModelConfig, b: Builder):
        super().__init__()
        if cfg.input_kind == "tokens":
            self.embed = b.param((cfg.vocab_size, cfg.d_model),
                                 ("vocab", "embed"), scale=cfg.d_model ** -0.5)
        for name, n, kind in _plan(cfg):
            if kind == "mamba":
                blocks = [MambaBlock(b, cfg) for _ in range(n)]
            elif kind == "moe":
                blocks = [TransformerBlock(b, cfg, ffn="moe")
                          for _ in range(n)]
            else:
                d_ff = (cfg.moe.dense_d_ff if cfg.family == "moe"
                        and cfg.moe.dense_d_ff else cfg.d_ff)
                blocks = [TransformerBlock(b, cfg, ffn="dense", d_ff=d_ff)
                          for _ in range(n)]
            setattr(self, name, nn.ModuleList(blocks))
        if cfg.family == "hybrid":
            self.shared = TransformerBlock(b, cfg, ffn="dense")
        self.final_norm = Norm(b, cfg.d_model, cfg.norm_kind)
        if not cfg.tie_embeddings:
            self.head = b.param((cfg.d_model, cfg.vocab_size),
                                ("embed", "vocab"))

    @property
    def device(self) -> torch.device:
        return self.final_norm.w.device


# ---------------- init ----------------

def init_lm(cfg: ModelConfig, seed: int = 0, device="cuda") -> LM:
    """An :class:`LM` of ``cfg`` on ``device`` in ``cfg.param_dtype``,
    drawn from a ``torch.Generator`` on ``device`` seeded with ``seed``.
    The default device is the card, and it raises where there is none;
    ``device='meta'`` allocates nothing."""
    dev = resolve_device(device)
    gen = None if dev.type == "meta" else \
        torch.Generator(device=dev).manual_seed(seed)
    return LM(cfg, Builder(gen, dtype=_dtype(cfg.param_dtype), device=dev))


# ---------------- shared helpers ----------------

def default_positions(cfg: ModelConfig, batch: int, seq: int, offset=0,
                      device="cpu"):
    """Positions ``(batch, seq)`` from ``offset`` (a scalar, or ``(batch,)``
    per request); ``(batch, seq, 3)`` for M-RoPE (text: t = h = w)."""
    if isinstance(offset, torch.Tensor) and \
            offset.device.type == torch.device(device).type:
        off = torch.as_tensor(offset, dtype=torch.int32, device=device)
    else:       # from the host: a blocking upload
        with trace.sync("model.positions"):
            off = torch.as_tensor(offset, dtype=torch.int32, device=device)
    if off.dim() == 1:
        off = off[:, None]
    pos = torch.arange(seq, dtype=torch.int32, device=device)[None, :] + off
    pos = pos.expand(batch, seq)
    if cfg.rope_kind == "mrope":
        return pos[:, :, None].expand(batch, seq, 3)
    return pos


def _rope(cfg: ModelConfig, positions):
    if cfg.attn is None and cfg.family != "hybrid":
        return None, None
    if cfg.attn == "mla":
        rot = cfg.mla.qk_rope
    else:
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
        # F.embedding's backward sums each row's gradients in a fixed
        # order; indexing's (an accumulating index_put) promises none
        # the table whole along its vocab axis (identity on one device): a
        # lookup in a vocab-sharded table gives a masked partial sum, whose
        # redistribution DTensor cannot run backwards
        table = constrain(params.embed, rules, None, "embed")
        x = F.embedding(_as(batch["tokens"], dev, torch.long), table)
    else:
        x = _as(batch["frames"], dev)
    x = x.to(_dtype(cfg.compute_dtype))
    return constrain(x, rules, "batch", "res_seq", "act_embed")


def _head(cfg, params, x, rules: Rules):
    x = norm(params.final_norm, x, cfg.norm_eps, cfg.norm_kind)
    w = params.embed.T if cfg.tie_embeddings else params.head
    logits = x @ w.to(x.dtype)
    return constrain(logits, rules, "batch", "seq", "act_vocab")


# the products 'dots' keeps: those with no batch dimension
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _maybe_remat(fn, remat: str):
    """``fn`` (a block's forward) checkpointed by ``remat``; as it is where
    autograd records nothing. The recompute runs under the mesh active now:
    the backward pass of CUDA tensors runs on autograd's own thread, which
    does not see the caller's ``set_mesh``."""
    if remat not in ("none", "full", "dots"):
        raise ValueError(f"unknown remat {remat!r}")
    if remat == "none" or not torch.is_grad_enabled():
        return fn
    mesh = get_mesh()

    def contexts():
        if remat == "dots":
            fwd, rec = create_selective_checkpoint_contexts(_dots_policy)
        else:
            fwd, rec = contextlib.nullcontext(), contextlib.nullcontext()
        return fwd, _recompute_context(rec, mesh)
    return functools.partial(checkpoint, fn, use_reentrant=False,
                             context_fn=contexts)


@contextlib.contextmanager
def _recompute_context(ctx, mesh):
    """``ctx`` entered under ``set_mesh(mesh)``, or alone where ``mesh`` is
    ``None``."""
    with (set_mesh(mesh) if mesh is not None else contextlib.nullcontext()):
        with ctx:
            yield


# ---------------- forward (train / prefill) ----------------

@mesh_inputs()
def forward(cfg: ModelConfig, params: LM, batch, rules: Rules,
            sort_impl: str = "xla", return_cache: bool = False,
            remat: Optional[str] = None):
    """Full-sequence forward. ``batch``: ``tokens`` ``(B, S)`` or
    ``frames`` ``(B, S, d)``, optional ``positions`` and ``seq_mask`` (the
    valid positions of a right-padded prefill, read by Mamba2 layers).
    Returns ``(logits, aux_loss, cache | None)``."""
    remat = cfg.remat if remat is None else remat
    x = _embed(cfg, params, batch, rules)
    bsz, seq = x.shape[:2]
    positions = batch.get("positions")
    positions = (default_positions(cfg, bsz, seq, device=x.device)
                 if positions is None else _as(positions, x.device))
    cos, sin = _rope(cfg, positions)
    seq_mask = batch.get("seq_mask")
    if seq_mask is not None:
        seq_mask = _as(seq_mask, x.device)

    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    caches: Dict[str, Any] = {}
    if cfg.family == "hybrid":
        x, caches = _hybrid_forward(cfg, params, x, cos, sin, rules,
                                    return_cache, seq_mask, remat)
    else:
        mamba = _maybe_remat(functools.partial(
            mamba_block, cfg, rules=rules, return_cache=return_cache,
            seq_mask=seq_mask), remat)
        transformer = _maybe_remat(functools.partial(
            transformer_block, cfg, rules=rules, return_cache=return_cache,
            sort_impl=sort_impl), remat)
        for name, _, kind in _plan(cfg):
            layer_caches = []
            for block in getattr(params, name):
                if kind == "mamba":
                    x, c = mamba(block, x)
                else:
                    x, c, aux = transformer(block, x, cos, sin)
                    aux_total = aux_total + aux
                layer_caches.append(c)
            if return_cache:
                caches[name] = _stack(layer_caches)

    logits = _head(cfg, params, x, rules)
    return logits, aux_total, (caches if return_cache else None)


def _stack(layer_caches):
    """Per-layer cache dicts as one dict of leaves with a leading layer
    axis."""
    return {k: torch.stack([c[k] for c in layer_caches])
            for k in layer_caches[0]}


def _hybrid_forward(cfg, params, x, cos, sin, rules, return_cache,
                    seq_mask, remat):
    """Zamba2: groups of [the shared block; ``hybrid_period`` Mamba2
    layers], the shared block's weights the same in every group; only the
    Mamba2 layers are checkpointed, as in the reference."""
    shared_caches, mamba_caches = [], []
    mamba = _maybe_remat(functools.partial(
        mamba_block, cfg, rules=rules, return_cache=return_cache,
        seq_mask=seq_mask), remat)
    for start, end in hybrid_groups(cfg):
        x, sc, _ = transformer_block(cfg, params.shared, x, cos, sin, rules,
                                     return_cache=return_cache)
        shared_caches.append(sc)
        for block in params.blocks[start:end]:
            x, c = mamba(block, x)
            mamba_caches.append(c)
    if not return_cache:
        return x, {}
    return x, {"shared": _stack(shared_caches),
               "blocks": _stack(mamba_caches)}


# ---------------- loss ----------------

@mesh_inputs()
def lm_loss(cfg: ModelConfig, params: LM, batch, rules: Rules,
            sort_impl: str = "xla"):
    """Mean next-token cross entropy (labels < 0 masked) + MoE aux.
    Returns ``(loss, {"ce", "aux"})``."""
    logits, aux, _ = forward(cfg, params, batch, rules, sort_impl=sort_impl)
    labels = _as(batch["labels"], logits.device, torch.long)
    # each row's whole vocabulary for the label's gather: a gather along a
    # vocab-sharded axis leaves a masked partial sum that DTensor cannot
    # reduce (the identity on one device)
    lf = constrain(logits.float(), rules, "batch", "seq", None)
    lse = torch.logsumexp(lf, dim=-1)
    ll = torch.take_along_dim(lf, labels.clamp(min=0)[..., None],
                              dim=-1)[..., 0]
    mask = (labels >= 0).float()
    ce = torch.sum((lse - ll) * mask) / torch.clamp(mask.sum(), min=1.0)
    return ce + aux, {"ce": ce, "aux": aux}


# ---------------- decode ----------------

@mesh_inputs()
def decode_step(cfg: ModelConfig, params: LM, cache, tokens_or_frames,
                cur_index, rules: Rules, sort_impl: str = "xla"):
    """One-token decode against ``cache`` (written in place). ``cur_index``:
    the position of the new token, a scalar or ``(B,)``. Returns ``(logits
    (B, 1, V), cache)``."""
    key = "tokens" if cfg.input_kind == "tokens" else "frames"
    x = _embed(cfg, params, {key: tokens_or_frames}, rules)
    bsz = x.shape[0]
    cur = _as(cur_index, x.device)
    positions = default_positions(cfg, bsz, 1, offset=cur, device=x.device)
    cos, sin = _rope(cfg, positions)

    def layer(stack, i):
        return {k: leaf[i] for k, leaf in stack.items()}

    if cfg.family == "hybrid":
        for gi, (start, end) in enumerate(hybrid_groups(cfg)):
            x, _, _ = transformer_block(cfg, params.shared, x, cos, sin,
                                        rules, cache=layer(cache["shared"],
                                                           gi),
                                        cur_index=cur)
            for i in range(start, end):
                x, _ = mamba_block(cfg, params.blocks[i], x, rules,
                                   cache=layer(cache["blocks"], i))
    else:
        for name, _, kind in _plan(cfg):
            for i, block in enumerate(getattr(params, name)):
                if kind == "mamba":
                    x, _ = mamba_block(cfg, block, x, rules,
                                       cache=layer(cache[name], i))
                else:
                    x, _, _ = transformer_block(
                        cfg, block, x, cos, sin, rules,
                        cache=layer(cache[name], i), cur_index=cur,
                        sort_impl=sort_impl)

    return _head(cfg, params, x, rules), cache


# ---------------- cache construction ----------------

_ATTN_AXES = {
    "k": ("layers", "cache_batch", "cache_seq", "cache_kv_heads", None),
    "v": ("layers", "cache_batch", "cache_seq", "cache_kv_heads", None),
    "ckv": ("layers", "cache_batch", "cache_seq", None),
    "kr": ("layers", "cache_batch", "cache_seq", None),
}
_SSM_AXES = {
    "conv": ("layers", "cache_batch", None, "act_mlp"),
    "ssm": ("layers", "cache_batch", "act_heads", None, None),
}


def init_cache(cfg: ModelConfig, batch: int, seq: int,
               abstract: bool = False, device="cuda"):
    """The zeroed decode cache of ``seq`` positions and its logical axes:
    ``(cache, axes)``. Mamba2 leaves are constant in ``seq``.
    ``abstract=True`` builds it on the ``meta`` device, allocating
    nothing."""
    dev = torch.device("meta") if abstract else resolve_device(device)
    dtype = _dtype(cfg.compute_dtype)

    def build(spec, n, axes):
        return ({k: torch.zeros((n,) + shape, dtype=dt, device=dev)
                 for k, (shape, dt) in spec.items()},
                {k: axes[k] for k in spec})

    def attn(n):
        return build(init_attn_cache(cfg, batch, seq, dtype), n, _ATTN_AXES)

    def ssm(n):
        return build(init_ssm_cache(cfg, batch, dtype), n, _SSM_AXES)

    cache, axes = {}, {}
    if cfg.family == "hybrid":
        cache["shared"], axes["shared"] = attn(len(hybrid_groups(cfg)))
        cache["blocks"], axes["blocks"] = ssm(cfg.n_layers)
    else:
        for name, n, kind in _plan(cfg):
            cache[name], axes[name] = ssm(n) if kind == "mamba" else attn(n)
    return cache, axes
