"""nemotron-4-340b [dense] — 96L d_model=18432 96H (GQA kv=8) d_ff=73728
vocab=256000, squared-ReLU MLP. [arXiv:2402.16819]

Paper technique is indirect here (no routing): length-bucketed data pipeline
and serving admission only — see DESIGN.md §6."""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b",
    family="dense",
    n_layers=96,
    d_model=18_432,
    n_heads=96,
    n_kv_heads=8,
    head_dim=192,
    d_ff=73_728,
    vocab_size=256_000,
    attn="gqa",
    mlp_act="relu2",            # squared ReLU, ungated
    mlp_gated=False,
    rope_kind="rope",
    rope_theta=10_000.0,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    optim_dtype="bfloat16",
    remat="full",               # 96 x d18432: activations dominate; full remat
    notes="GQA kv=8; squared-ReLU; 256k vocab.",
)
