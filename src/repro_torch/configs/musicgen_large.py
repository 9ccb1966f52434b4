"""musicgen-large [audio] — 48L d_model=2048 32H d_ff=8192 vocab=2048,
decoder-only over EnCodec tokens. [arXiv:2306.05284]

Backbone only: the EnCodec frontend is a stub — ``input_specs()`` provides
precomputed frame embeddings; the head predicts one codebook (vocab 2048)."""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,              # full MHA
    head_dim=64,
    d_ff=8192,
    vocab_size=2048,
    attn="gqa",
    mlp_act="gelu",
    mlp_gated=False,
    rope_kind="none",           # musicgen uses learned sinusoidal; stubbed as none
    norm_kind="layernorm",
    input_kind="frames",
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    remat="dots",
    notes="decoder over EnCodec frames; frontend stubbed per assignment.",
)
