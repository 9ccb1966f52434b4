"""granite-moe-1b-a400m [moe] — 24L d_model=1024 16H (GQA kv=8) d_ff=512
vocab=49155, MoE 32 experts top-8. [hf:ibm-granite/granite-3.0-1b-a400m-base]

Paper-technique hook: sort-based MoE token dispatch (models/moe.py)."""

from ..models.config import ModelConfig, MoECfg

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab_size=49_155,
    attn="gqa",
    mlp_act="silu",
    mlp_gated=True,
    moe=MoECfg(n_experts=32, top_k=8, d_expert=512, impl="sort"),
    rope_kind="rope",
    rope_theta=10_000.0,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    optim_dtype="float32",
    remat="dots",
    notes="32e top-8; every layer MoE; GQA kv=8.",
)
