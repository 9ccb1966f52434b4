"""Abstract inputs and their placements for every dry-run cell — the
counterpart of ``repro.launch.specs``.

``input_specs`` builds the argument trees that the train, prefill and
decode steps take, as ``meta`` tensors (global shapes and dtypes,
nothing allocated; the reference's ``ShapeDtypeStruct``s), together with
a matching :class:`~repro_torch.parallel.sharding.NamedSharding` for each
leaf, derived from the logical-axis rules (``models.param.tree_specs``
and ``Rules.shape_spec``). The parameters are an ``LM`` on ``meta`` and
their shardings a ``{name: NamedSharding}`` named as its
``named_parameters``; ``launch.dryrun`` turns both into ``DTensor``s of
``meta`` local shards.
"""

from __future__ import annotations

import torch

from ..configs import ShapeCell
from ..models.config import ModelConfig
from ..models.model import init_cache, init_lm
from ..models.param import finalize, tree_specs
from ..optim import init_opt_state, opt_state_axes
from ..parallel.sharding import NamedSharding, Rules, mesh_sizes

__all__ = ["input_specs", "abstract_state", "shardings_for", "count_params"]

_META = torch.device("meta")


def _dt(name):
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def _map(fn, tree):
    return {k: _map(fn, v) for k, v in tree.items()} \
        if isinstance(tree, dict) else fn(tree)


def shardings_for(axes_tree, rules: Rules, mesh, value_tree=None):
    """``NamedSharding(mesh, spec)`` for every leaf of a (nested) dict of
    logical axes; with ``value_tree`` (tensors of the same structure, or
    an ``nn.Module``) the divisibility-aware specs of their shapes."""
    specs = tree_specs(axes_tree, rules, mesh, value_tree)
    return _map(lambda s: NamedSharding(mesh, s), specs)


def abstract_state(cfg: ModelConfig, rules: Rules, mesh,
                   with_opt: bool = True):
    """``(params, params_shardings[, opt_state, opt_shardings])``:
    ``params`` the ``LM`` on ``meta``, ``opt_state`` AdamW's ``{"m", "v",
    "count"}`` on ``meta`` in ``cfg.optim_dtype``."""
    params = init_lm(cfg, device=_META)
    axes = finalize(params)
    p_shard = shardings_for(axes, rules, mesh, params)
    if not with_opt:
        return params, p_shard
    opt = init_opt_state(params, moment_dtype=_dt(cfg.optim_dtype))
    o_shard = shardings_for(opt_state_axes(axes), rules, mesh, opt)
    return params, p_shard, opt, o_shard


def _ns(mesh, rules: Rules, axes, shape):
    return NamedSharding(mesh, rules.shape_spec(axes, shape,
                                                mesh_sizes(mesh)))


def _sds(shape, dtype):
    return torch.empty(shape, dtype=dtype, device=_META)


def _batch_specs(cfg: ModelConfig, cell: ShapeCell, rules: Rules, mesh,
                 with_labels: bool):
    b, s = cell.global_batch, cell.seq_len
    tree, shard = {}, {}
    if cfg.input_kind == "tokens":
        tree["tokens"] = _sds((b, s), torch.int32)
        shard["tokens"] = _ns(mesh, rules, ("batch", "seq"), (b, s))
    else:
        tree["frames"] = _sds((b, s, cfg.d_model), _dt(cfg.compute_dtype))
        shard["frames"] = _ns(mesh, rules, ("batch", "seq", "act_embed"),
                              (b, s, cfg.d_model))
    if cfg.rope_kind == "mrope":
        tree["positions"] = _sds((b, s, 3), torch.int32)
        shard["positions"] = _ns(mesh, rules, ("batch", "seq", None),
                                 (b, s, 3))
    if with_labels:
        tree["labels"] = _sds((b, s), torch.int32)
        shard["labels"] = _ns(mesh, rules, ("batch", "seq"), (b, s))
    return tree, shard


def input_specs(cfg: ModelConfig, cell: ShapeCell, rules: Rules, mesh):
    """Returns ``(args, args_shardings)`` for the cell's step function.

    train:   (params, opt_state, batch, step)
    prefill: (params, batch)
    decode:  (params, cache, tok, cur_index)
    """
    if cell.kind == "train":
        params, p_sh, opt, o_sh = abstract_state(cfg, rules, mesh)
        batch, b_sh = _batch_specs(cfg, cell, rules, mesh, with_labels=True)
        step = _sds((), torch.int32)
        return (params, opt, batch, step), (p_sh, o_sh, b_sh,
                                            NamedSharding(mesh, ()))

    if cell.kind == "prefill":
        params, p_sh = abstract_state(cfg, rules, mesh, with_opt=False)
        batch, b_sh = _batch_specs(cfg, cell, rules, mesh, with_labels=False)
        return (params, batch), (p_sh, b_sh)

    if cell.kind == "decode":
        params, p_sh = abstract_state(cfg, rules, mesh, with_opt=False)
        cache, c_axes = init_cache(cfg, cell.global_batch, cell.seq_len,
                                   abstract=True)
        c_sh = shardings_for(c_axes, rules, mesh, cache)
        if cfg.input_kind == "tokens":
            tok = _sds((cell.global_batch, 1), torch.int32)
            t_sh = _ns(mesh, rules, ("cache_batch", None), tok.shape)
        else:
            tok = _sds((cell.global_batch, 1, cfg.d_model),
                       _dt(cfg.compute_dtype))
            t_sh = _ns(mesh, rules, ("cache_batch", None, None), tok.shape)
        cur = _sds((), torch.int32)
        return (params, cache, tok, cur), (p_sh, c_sh, t_sh,
                                           NamedSharding(mesh, ()))

    raise ValueError(f"unknown cell kind {cell.kind!r}")


def count_params(cfg: ModelConfig):
    """(total, active) parameter counts from the ``meta`` LM; the MoE
    experts' ``w_in``/``w_out`` count ``top_k / n_experts`` of themselves
    as active, as the reference's ``count_params`` does."""
    total = 0
    expert = 0
    for name, p in init_lm(cfg, device=_META).named_parameters():
        n = p.numel()
        total += n
        if "moe" in name and ("w_in" in name or "w_out" in name):
            expert += n
    active = total - expert
    if cfg.moe is not None and expert:
        active += expert * cfg.moe.top_k // cfg.moe.n_experts
    return total, active
