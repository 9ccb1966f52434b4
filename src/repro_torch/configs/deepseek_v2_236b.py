"""deepseek-v2-236b [moe] — 60L d_model=5120 128H d_ff=1536(expert)
vocab=102400, MLA kv_lora=512, 2 shared + 160 routed top-6. [arXiv:2405.04434]

Paper-technique hook: sort-based MoE dispatch with expert parallelism over
the `model` mesh axis (160 experts / 16-way EP = 10 per chip)."""

from ..models.config import MLACfg, ModelConfig, MoECfg

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,            # MLA: per-head kv materialized from the latent
    head_dim=128,
    d_ff=1536,                 # routed expert width
    vocab_size=102_400,
    attn="mla",
    mla=MLACfg(q_lora=1536, kv_lora=512, qk_nope=128, qk_rope=64, v_head=128),
    mlp_act="silu",
    mlp_gated=True,
    moe=MoECfg(
        n_experts=160, top_k=6, d_expert=1536,
        n_shared=2, d_shared=1536,
        first_dense=1, dense_d_ff=12_288,
        impl="sort",
    ),
    rope_kind="rope",
    rope_theta=10_000.0,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    optim_dtype="bfloat16",    # 236B params: bf16 moments to fit the pod
    remat="dots",
    notes="MLA compressed KV cache (kv_lora+qk_rope per token); layer 0 dense.",
)
