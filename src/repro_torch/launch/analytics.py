"""Closed-form per-device FLOPs / HBM-bytes / collective-bytes accounting
— the counterpart of ``repro.launch.analytics``, formula for formula and in
the same order of operations, read against the H100's constants
(``launch.hw``).

The reference keeps it because XLA's ``cost_analysis()`` counts a scanned
layer once; the port's dry run (``launch.dryrun``) counts every op it runs,
so here it is the cross-check of the traced numbers and the model that the
hillclimb's levers are read in. All formulas below are standard
transformer accounting; assumptions are explicit per function.

Sharding assumptions mirror parallel/sharding.DEFAULT_RULES:
  batch over (pod, data); TP over model (heads/mlp/vocab/experts);
  FSDP over data (params gathered per layer);
  gradients reduce-scattered over data, all-reduced over pod.

Every field is the reference's for the same inputs but those that read
``hw``: the roofline's seconds, its bottleneck and fraction, and
``hbm_capacity_check``'s budget and ``fits`` (80 GB a card, where the v5e
has 16 GiB). The collective term divides by ``hw.NVLINK_BW`` where the
reference divides by its ICI link rate (see ``launch.hw`` on which link a
16 x 16 mesh's axes really cross).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

from ..configs import ShapeCell
from ..models.config import ModelConfig
from . import hw

__all__ = ["cell_analytics", "hbm_capacity_check"]


def _param_count(cfg: ModelConfig) -> tuple[int, int]:
    from .specs import count_params
    return count_params(cfg)


def _attn_flops_per_layer(cfg: ModelConfig, tokens: int, ctx: float, decode: bool) -> float:
    d = cfg.d_model
    if cfg.attn == "mla":
        m = cfg.mla
        h = cfg.n_heads
        q_proj = 2 * tokens * (d * m.q_lora + m.q_lora * h * (m.qk_nope + m.qk_rope)) \
            if m.q_lora else 2 * tokens * d * h * (m.qk_nope + m.qk_rope)
        kv_a = 2 * tokens * d * (m.kv_lora + m.qk_rope)
        if decode:
            # absorbed path: scores/ctx run in the latent space
            absorb = 2 * tokens * h * m.qk_nope * m.kv_lora
            scores = 2 * tokens * ctx * h * (m.kv_lora + m.qk_rope)
            ctx_f = 2 * tokens * ctx * h * m.kv_lora
            up_v = 2 * tokens * h * m.kv_lora * m.v_head
            o = 2 * tokens * h * m.v_head * d
            return q_proj + kv_a + absorb + scores + ctx_f + up_v + o
        kv_b = 2 * tokens * m.kv_lora * cfg.n_heads * (m.qk_nope + m.v_head)
        scores = 2 * tokens * ctx * h * (m.qk_nope + m.qk_rope)
        av = 2 * tokens * ctx * h * m.v_head
        o = 2 * tokens * h * m.v_head * d
        return q_proj + kv_a + kv_b + scores + av + o
    # GQA
    h, kh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    proj = 2 * tokens * d * (h * dh + 2 * kh * dh + h * dh)
    scores_av = 2 * tokens * ctx * h * dh * 2
    return proj + scores_av


def _mlp_flops(cfg, tokens, d_ff) -> float:
    mult = 3 if cfg.mlp_gated else 2
    return 2 * tokens * cfg.d_model * d_ff * mult


def _moe_flops_per_layer(cfg, tokens) -> float:
    m = cfg.moe
    routed = 2 * tokens * m.top_k * cfg.d_model * m.d_expert * (3 if cfg.mlp_gated else 2)
    shared = _mlp_flops(cfg, tokens, m.n_shared * m.d_shared) if m.n_shared else 0.0
    router = 2 * tokens * cfg.d_model * m.n_experts
    # sort-based dispatch: O(Tk log Tk) comparator work, negligible FLOPs
    return routed + shared + router


def _mamba_flops_per_layer(cfg, tokens) -> float:
    s = cfg.ssm
    di = s.expand * cfg.d_model
    nh = di // s.headdim
    conv_dim = di + 2 * s.n_groups * s.d_state
    in_proj = 2 * tokens * cfg.d_model * (2 * di + 2 * s.n_groups * s.d_state + nh)
    conv = 2 * tokens * s.d_conv * conv_dim
    # SSD: intra-chunk quadratic (chunk Q) + state path, both O(T Q di) / O(T di N)
    q = min(s.chunk, max(tokens, 1))
    ssd = 2 * tokens * q * di + 4 * tokens * di * s.d_state
    out = 2 * tokens * di * cfg.d_model
    return in_proj + conv + ssd + out


def _layer_flops(cfg: ModelConfig, tokens: int, ctx: float, decode: bool) -> float:
    """Forward FLOPs of ONE layer (attention/moe/mamba per family)."""
    if cfg.family in ("ssm", "hybrid"):
        f = _mamba_flops_per_layer(cfg, tokens)
        return f
    attn = _attn_flops_per_layer(cfg, tokens, ctx, decode)
    if cfg.family == "moe":
        return attn + _moe_flops_per_layer(cfg, tokens)
    return attn + _mlp_flops(cfg, tokens, cfg.d_ff)


def _forward_flops_global(cfg: ModelConfig, cell: ShapeCell) -> float:
    decode = cell.kind == "decode"
    tokens = cell.global_batch * (1 if decode else cell.seq_len)
    ctx = float(cell.seq_len) if decode else cell.seq_len / 2.0  # causal avg
    total = cfg.n_layers * _layer_flops(cfg, tokens, ctx, decode)
    if cfg.family == "hybrid":
        n_apps = -(-cfg.n_layers // cfg.hybrid_period)
        total += n_apps * (_attn_flops_per_layer(cfg, tokens, ctx, decode)
                           + _mlp_flops(cfg, tokens, cfg.d_ff))
    total += 2 * tokens * cfg.d_model * cfg.vocab_size  # lm head
    return total


@dataclasses.dataclass
class MeshModel:
    pod: int
    data: int
    model: int

    @property
    def devices(self):
        return self.pod * self.data * self.model

    @property
    def batch_shards(self):
        return self.pod * self.data


def cell_analytics(cfg: ModelConfig, cell: ShapeCell, multi_pod: bool,
                   accum: int = 1, sp: bool = False,
                   weights_resident: bool = False,
                   int8_collectives: bool = False) -> Dict:
    """Per-device roofline terms for one cell.

    Variants (the §Perf hillclimb levers):
      sp                 Megatron sequence parallelism: residual activations
                         sharded over `model`; activation HBM and saved-residual
                         memory drop ~16x; the TP all-reduce becomes
                         reduce-scatter + all-gather (same bytes).
      weights_resident   inference plan: params sharded over `model` only and
                         resident (no per-step FSDP gather); valid when
                         P_bytes/model fits HBM alongside the cache.
      int8_collectives   activation all-reduces quantized int8 with error
                         feedback (parallel/compression.py): halves the bf16
                         TP/pod payload. Modeled here; the collective itself
                         is implemented and property-tested in shard_map form.
    """
    mesh = MeshModel(2 if multi_pod else 1, 16, 16)
    bytes_per_param = 2 if cfg.param_dtype == "bfloat16" else 4
    total_p, active_p = _param_count(cfg)
    p_bytes = total_p * bytes_per_param

    decode = cell.kind == "decode"
    train = cell.kind == "train"
    tokens_global = cell.global_batch * (1 if decode else cell.seq_len)
    tokens_loc = tokens_global / mesh.batch_shards

    fwd = _forward_flops_global(cfg, cell)
    if train:
        # bwd = 2x fwd; full remat recomputes the forward once more
        mult_f = 4.0 if cfg.remat == "full" else 3.0
    else:
        mult_f = 1.0
    flops_global = fwd * mult_f
    flops_dev = flops_global / mesh.devices

    # ---- HBM bytes per device ----
    # weights: gathered per layer => each device streams the full TP shard
    # of every layer (fwd + bwd) per microbatch; optimizer touches the local
    # FSDP shard only.
    act_bytes_elem = 2 if cfg.compute_dtype == "bfloat16" else 4
    w_stream = (p_bytes / mesh.model) * (2 * accum if train else 1)
    opt_touch = (p_bytes / (mesh.model * mesh.data)) * (6 if train else 0)
    act_shard = mesh.model if sp else 1
    act_traffic = 10.0 * tokens_loc * cfg.d_model * act_bytes_elem * cfg.n_layers \
        * (3.0 if train else 1.0) / act_shard
    logits_traffic = 3.0 * tokens_loc * (cfg.vocab_size / mesh.model) * 4
    cache_traffic = 0.0
    if decode:
        cache_traffic = _cache_bytes_global(cfg, cell) / mesh.devices
    hbm_dev = w_stream + opt_touch + act_traffic + logits_traffic + cache_traffic

    # ---- collective bytes per device (payload; multipliers in hw) ----
    coll = {}
    # TP all-reduce of activations: 2 per layer fwd (+2 bwd when training).
    # Under SP the AR becomes RS+AG with identical total payload.
    ars_per_layer = 4 if train else 2
    coll["tp_all_reduce"] = (cfg.n_layers * ars_per_layer
                             * tokens_loc * cfg.d_model * act_bytes_elem)
    # FSDP all-gather of params (per microbatch, fwd+bwd) over data axis
    fsdp_frac = (mesh.data - 1) / mesh.data
    if weights_resident and not train:
        coll["fsdp_all_gather"] = 0.0   # params live TP-sharded, no gather
    else:
        coll["fsdp_all_gather"] = (p_bytes / mesh.model) * fsdp_frac \
            * ((2 * accum) if train else 1)
    if train:
        # grad reduce-scatter over data + all-reduce over pods (DCN)
        coll["grad_reduce_scatter"] = (p_bytes / mesh.model) * fsdp_frac
        if mesh.pod > 1:
            coll["pod_grad_all_reduce"] = p_bytes / (mesh.model * mesh.data)
    if cfg.family == "moe":
        k = cfg.moe.top_k
        a2a = tokens_loc * k * cfg.d_model * act_bytes_elem * 2  # there+back
        coll["ep_all_to_all"] = a2a * (3.0 if train else 1.0)
    coll_bytes = sum(coll.values())

    compute_s = flops_dev / hw.PEAK_FLOPS_BF16
    memory_s = hbm_dev / hw.HBM_BW
    act_coll_scale = 0.5 if int8_collectives else 1.0  # bf16 -> int8 payload
    collective_s = (
        coll["tp_all_reduce"] * 2.0 * act_coll_scale
        + coll.get("fsdp_all_gather", 0.0)
        + coll.get("grad_reduce_scatter", 0.0)
        + coll.get("pod_grad_all_reduce", 0.0) * 2.0 * act_coll_scale
        + coll.get("ep_all_to_all", 0.0)
    ) / hw.NVLINK_BW
    terms = {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
    }
    dominant = max(terms, key=terms.get)
    mult = 6 if train else 2
    model_flops_dev = mult * active_p * tokens_global / mesh.devices
    return {
        "flops_per_device": flops_dev,
        "hbm_bytes_per_device": hbm_dev,
        "collective_bytes_per_device": coll_bytes,
        "collective_breakdown": coll,
        "roofline": dict(terms, bottleneck=dominant),
        "useful_flops_ratio": model_flops_dev / flops_dev if flops_dev else None,
        "step_time_bound_s": max(terms.values()),
        "roofline_fraction": compute_s / max(terms.values()) if max(terms.values()) else 0.0,
    }


def _cache_bytes_global(cfg: ModelConfig, cell: ShapeCell) -> float:
    b, s = cell.global_batch, cell.seq_len
    elem = 2 if cfg.compute_dtype == "bfloat16" else 4
    if cfg.family == "ssm":
        st = cfg.ssm
        di = st.expand * cfg.d_model
        nh = di // st.headdim
        conv_dim = di + 2 * st.n_groups * st.d_state
        per_layer = b * ((st.d_conv - 1) * conv_dim * elem
                         + nh * st.headdim * st.d_state * 4)
        return cfg.n_layers * per_layer
    if cfg.family == "hybrid":
        st = cfg.ssm
        di = st.expand * cfg.d_model
        nh = di // st.headdim
        conv_dim = di + 2 * st.n_groups * st.d_state
        mamba = cfg.n_layers * b * ((st.d_conv - 1) * conv_dim * elem
                                    + nh * st.headdim * st.d_state * 4)
        n_apps = -(-cfg.n_layers // cfg.hybrid_period)
        attn = n_apps * b * s * 2 * cfg.n_kv_heads * cfg.head_dim * elem
        return mamba + attn
    if cfg.attn == "mla":
        return cfg.n_layers * b * s * (cfg.mla.kv_lora + cfg.mla.qk_rope) * elem
    return cfg.n_layers * b * s * 2 * cfg.n_kv_heads * cfg.head_dim * elem


def hbm_capacity_check(cfg: ModelConfig, cell: ShapeCell, multi_pod: bool,
                       accum: int = 1, sp: bool = False,
                       weights_resident: bool = False) -> Dict:
    """Static per-device HBM demand vs the card's budget (``hw.HBM_BYTES``,
    80 GB on the H100)."""
    mesh = MeshModel(2 if multi_pod else 1, 16, 16)
    bpp = 2 if cfg.param_dtype == "bfloat16" else 4
    bpo = 2 if cfg.optim_dtype == "bfloat16" else 4
    total_p, _ = _param_count(cfg)
    # params: FSDP x TP sharded, or TP-only when resident for inference
    shard = mesh.model if weights_resident else mesh.model * mesh.data
    params = total_p * bpp / shard
    train = cell.kind == "train"
    opt = total_p * 2 * bpo / (mesh.model * mesh.data) if train else 0.0
    grads = total_p * bpp / (mesh.model * mesh.data) if train else 0.0
    act_elem = 2 if cfg.compute_dtype == "bfloat16" else 4
    act_shard = mesh.model if sp else 1
    if train:
        tokens_loc = cell.global_batch * cell.seq_len / (mesh.batch_shards * accum)
        # residual saved per layer boundary (full remat inside layers)
        acts = tokens_loc * cfg.d_model * act_elem * cfg.n_layers / act_shard
        logits = tokens_loc * cfg.vocab_size / mesh.model * 4
    else:
        tokens_loc = cell.global_batch * (1 if cell.kind == "decode" else cell.seq_len) \
            / mesh.batch_shards
        acts = tokens_loc * cfg.d_model * act_elem * 4 / act_shard
        logits = tokens_loc * cfg.vocab_size / mesh.model * 4
    cache = _cache_bytes_global(cfg, cell) / mesh.devices if cell.kind != "train" else 0.0
    total = params + opt + grads + acts + logits + cache
    return {
        "params_gib": params / 2**30,
        "opt_gib": opt / 2**30,
        "grads_gib": grads / 2**30,
        "activations_gib": acts / 2**30,
        "logits_gib": logits / 2**30,
        "cache_gib": cache / 2**30,
        "total_gib": total / 2**30,
        "budget_gib": hw.HBM_BYTES / 2**30,
        "fits": total <= hw.HBM_BYTES,
    }
