"""Model configuration schema for the architecture zoo — a copy of
``repro.models.config``, field for field, so both packages read the same
configurations.

One frozen dataclass tree describes every architecture; ``configs/``
instantiates them with the exact published dimensions. ``smoke_variant``
derives the reduced configuration of the CPU tests.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["MoECfg", "MLACfg", "SSMCfg", "ModelConfig", "smoke_variant"]


@dataclasses.dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    d_expert: int                  # per-expert FFN width
    n_shared: int = 0              # shared (always-on) experts
    d_shared: int = 0              # width of the shared expert FFN
    capacity_factor: float = 1.25
    impl: str = "sort"             # 'sort' (paper technique) | 'einsum' (baseline)
    router_renorm: bool = True     # renormalize top-k probs
    first_dense: int = 0           # leading layers with a dense FFN instead
    dense_d_ff: int = 0
    aux_alpha: float = 0.01        # load-balance loss weight


@dataclasses.dataclass(frozen=True)
class MLACfg:
    q_lora: int        # query low-rank dim (0 = full-rank queries)
    kv_lora: int       # compressed KV latent dim (this IS the decode cache)
    qk_nope: int       # non-rotary per-head qk dim
    qk_rope: int       # rotary per-head qk dim (single shared key head)
    v_head: int        # per-head value dim


@dataclasses.dataclass(frozen=True)
class SSMCfg:
    d_state: int
    expand: int = 2
    headdim: int = 64
    chunk: int = 256
    d_conv: int = 4
    n_groups: int = 1


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    attn: Optional[str] = "gqa"    # gqa | mla | None (attention-free)
    mlp_act: str = "silu"          # silu | relu2 | gelu
    mlp_gated: bool = True
    moe: Optional[MoECfg] = None
    mla: Optional[MLACfg] = None
    ssm: Optional[SSMCfg] = None
    hybrid_period: int = 0         # zamba2: shared attn block every N ssm layers
    rope_kind: str = "rope"        # rope | mrope | none
    rope_theta: float = 10_000.0
    rope_pct: float = 1.0          # glm4: partial rotary
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)
    attn_kv_chunk: int = 0         # >0: streaming (flash-style) attention over
                                   # KV chunks of this size — bounds prefill
                                   # memory to O(S*chunk) instead of O(S^2)
    input_kind: str = "tokens"     # tokens | frames (modality-frontend stub)
    norm_kind: str = "rmsnorm"     # rmsnorm | layernorm
    norm_eps: float = 1e-5
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    optim_dtype: str = "float32"   # AdamW moment dtype (bf16 = memory trick)
    remat: str = "none"            # none | dots | full
    tie_embeddings: bool = False
    notes: str = ""

    # ---- derived ----
    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the long_500k cell (SSM state or hybrid)."""
        return self.family in ("ssm", "hybrid")

    @property
    def q_per_kv(self) -> int:
        return max(1, self.n_heads // max(1, self.n_kv_heads))

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


def smoke_variant(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests: small layers/width,
    few experts, tiny vocab. Preserves every structural feature (GQA ratio,
    MLA, MoE routing, hybrid period, M-RoPE sections...)."""
    kw: dict = dict(
        n_layers=4 if cfg.hybrid_period else 2,
        d_model=64,
        n_heads=4,
        n_kv_heads=max(1, min(2, cfg.n_kv_heads)),
        head_dim=16,
        d_ff=128,
        vocab_size=128,
        param_dtype="float32",
        compute_dtype="float32",
        optim_dtype="float32",
        remat="none",
    )
    if cfg.hybrid_period:
        kw["hybrid_period"] = 2
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(
            cfg.moe,
            n_experts=min(4, cfg.moe.n_experts),
            top_k=min(2, cfg.moe.top_k),
            d_expert=32,
            d_shared=32 if cfg.moe.n_shared else 0,
            dense_d_ff=64 if cfg.moe.first_dense else 0,
        )
    if cfg.mla is not None:
        kw["mla"] = MLACfg(
            q_lora=32 if cfg.mla.q_lora else 0,
            kv_lora=16, qk_nope=8, qk_rope=8, v_head=16,
        )
        kw["head_dim"] = 16  # unused by MLA path but kept consistent
    if cfg.ssm is not None:
        kw["ssm"] = dataclasses.replace(
            cfg.ssm, d_state=16, headdim=16, chunk=8, n_groups=1
        )
    if cfg.rope_kind == "mrope":
        kw["mrope_sections"] = (2, 3, 3)  # sums to head_dim//2 = 8
    return cfg.replace(**kw)
