"""glm4-9b [dense] — 40L d_model=4096 32H (GQA kv=2) d_ff=13696
vocab=151552, partial RoPE. [hf:THUDM/glm-4-9b]"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="glm4-9b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    head_dim=128,
    d_ff=13_696,
    vocab_size=151_552,
    attn="gqa",
    mlp_act="silu",
    mlp_gated=True,
    rope_kind="rope",
    rope_theta=10_000.0,
    rope_pct=0.5,               # GLM partial rotary
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    remat="dots",
    notes="GQA kv=2 (extreme KV compression); partial RoPE 50%.",
)
