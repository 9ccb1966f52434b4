"""mamba2-370m [ssm] — 48L d_model=1024 attention-free, ssm_state=128,
vocab=50280. SSD (state-space duality). [arXiv:2405.21060]

Runs the long_500k cell: decode state is O(1) in context length."""

from ..models.config import ModelConfig, SSMCfg

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=32,                # d_inner / headdim (derived; unused by attn)
    n_kv_heads=32,
    head_dim=64,
    d_ff=0,                    # no MLP: the mamba mixer is the whole block
    vocab_size=50_280,
    attn=None,
    ssm=SSMCfg(d_state=128, expand=2, headdim=64, chunk=256, d_conv=4, n_groups=1),
    rope_kind="none",
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    remat="dots",
    notes="pure SSM; decode cache = conv window + (H,P,N) state per layer.",
)
