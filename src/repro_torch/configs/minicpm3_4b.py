"""minicpm3-4b [dense] — 62L d_model=2560 40H d_ff=6400 vocab=73448, MLA.
[hf:openbmb/MiniCPM3-4B]"""

from ..models.config import MLACfg, ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b",
    family="dense",
    n_layers=62,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    head_dim=64,
    d_ff=6400,
    vocab_size=73_448,
    attn="mla",
    mla=MLACfg(q_lora=768, kv_lora=256, qk_nope=64, qk_rope=32, v_head=64),
    mlp_act="silu",
    mlp_gated=True,
    rope_kind="rope",
    rope_theta=10_000.0,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    remat="dots",
    notes="MLA with q_lora=768/kv_lora=256.",
)
