"""Optimizer substrate of the port — the counterpart of ``repro.optim``:
AdamW over named parameter tensors, updated in place; global-norm
clipping; the cosine schedule with warm-up."""

from .adamw import AdamWConfig, adamw_update, init_opt_state, opt_state_axes
from .clip import clip_by_global_norm, global_norm
from .schedule import cosine_schedule

__all__ = [
    "AdamWConfig", "init_opt_state", "adamw_update", "opt_state_axes",
    "cosine_schedule", "clip_by_global_norm", "global_norm",
]
