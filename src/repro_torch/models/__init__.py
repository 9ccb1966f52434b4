"""The model stack of the port — the counterpart of ``repro.models``:
every token or frames architecture with GQA attention (dense, MoE, vlm,
audio), assembled from the same primitives as the reference (attention,
MoE with the paper's sort-based dispatch), driven by ``ModelConfig``. MLA,
SSM and the SSM hybrid wait for ROADMAP A13."""

from .config import MLACfg, ModelConfig, MoECfg, SSMCfg, smoke_variant
from .model import (LM, decode_step, default_positions, forward, init_cache,
                    init_lm, lm_loss)

__all__ = [
    "ModelConfig", "MoECfg", "MLACfg", "SSMCfg", "smoke_variant",
    "LM", "init_lm", "forward", "lm_loss", "decode_step", "init_cache",
    "default_positions",
]
