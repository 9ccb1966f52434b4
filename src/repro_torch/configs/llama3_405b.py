"""llama3-405b [dense] — 126L d_model=16384 128H (GQA kv=8) d_ff=53248
vocab=128256. [arXiv:2407.21783]"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b",
    family="dense",
    n_layers=126,
    d_model=16_384,
    n_heads=128,
    n_kv_heads=8,
    head_dim=128,
    d_ff=53_248,
    vocab_size=128_256,
    attn="gqa",
    mlp_act="silu",
    mlp_gated=True,
    rope_kind="rope",
    rope_theta=500_000.0,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    optim_dtype="bfloat16",     # 405B: bf16 moments to fit 512 x 16GB
    remat="full",
    notes="GQA kv=8; 128k vocab; rope theta 500k.",
)
