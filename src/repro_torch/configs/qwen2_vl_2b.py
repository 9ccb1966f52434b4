"""qwen2-vl-2b [vlm] — 28L d_model=1536 12H (GQA kv=2) d_ff=8960
vocab=151936, M-RoPE. [arXiv:2409.12191]

Backbone only: the dynamic-resolution ViT frontend is a stub —
``input_specs()`` provides precomputed patch embeddings plus (t,h,w)
M-RoPE position ids."""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab_size=151_936,
    attn="gqa",
    mlp_act="silu",
    mlp_gated=True,
    rope_kind="mrope",
    rope_theta=1_000_000.0,
    mrope_sections=(16, 24, 24),   # t/h/w frequency sections (sum = 64 pairs)
    input_kind="frames",           # precomputed patch embeddings
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    remat="dots",
    notes="M-RoPE over patch embeddings; ViT frontend stubbed per assignment.",
)
