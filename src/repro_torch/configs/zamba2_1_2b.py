"""zamba2-1.2b [hybrid] — 38L d_model=2048 32H d_ff=8192 vocab=32000,
ssm_state=64; Mamba2 backbone + shared attention block. [arXiv:2411.15242]

Hybrid layout: one *shared* transformer block (single param set) applied
before every 6-layer group of Mamba2 blocks. Runs the long_500k cell: the
mamba state is O(1) and only the 7 shared-block applications keep KV.
"""

from ..models.config import ModelConfig, SSMCfg

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,                  # shared block MLP width
    vocab_size=32_000,
    attn="gqa",                 # the shared block's attention
    mlp_act="gelu",
    mlp_gated=True,
    ssm=SSMCfg(d_state=64, expand=2, headdim=64, chunk=256, d_conv=4, n_groups=1),
    hybrid_period=6,
    rope_kind="rope",
    rope_theta=10_000.0,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    remat="dots",
    notes="shared attn+MLP block every 6 mamba layers (7 applications).",
)
