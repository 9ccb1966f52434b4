"""The model stack of the port — the counterpart of ``repro.models``: every
family of the architecture pool (dense, MoE, vlm and audio with GQA or MLA
attention; the Mamba2 SSM; the Zamba2 hybrid), assembled from the same
primitives as the reference (attention, MoE with the paper's sort-based
dispatch, the chunked SSD), driven by ``ModelConfig``."""

from .config import MLACfg, ModelConfig, MoECfg, SSMCfg, smoke_variant
from .model import (LM, decode_step, default_positions, forward,
                    hybrid_groups, init_cache, init_lm, lm_loss)
from .ssm import init_ssm_cache, mamba_decode, mamba_train, ssd_reference

__all__ = [
    "ModelConfig", "MoECfg", "MLACfg", "SSMCfg", "smoke_variant",
    "LM", "init_lm", "forward", "lm_loss", "decode_step", "init_cache",
    "default_positions", "hybrid_groups",
    "mamba_train", "mamba_decode", "init_ssm_cache", "ssd_reference",
]
