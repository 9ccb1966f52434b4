"""Learning-rate schedules — the counterpart of ``repro.optim.schedule``."""

from __future__ import annotations

import math

import torch

__all__ = ["cosine_schedule"]


def cosine_schedule(base_lr: float, warmup: int, total: int,
                    min_frac: float = 0.1):
    """Linear warm-up, then cosine decay to ``min_frac * base_lr``.
    Returns ``lr(step)``: a 0-d float32 CPU tensor, computed in float32 as
    the reference computes it."""
    f32 = torch.float32

    def lr(step):
        step = torch.as_tensor(step).to(f32)
        warm = base_lr * torch.clamp(step / max(warmup, 1), max=1.0)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = base_lr * (min_frac + (1 - min_frac) * 0.5
                         * (1 + torch.cos(math.pi * t)))
        return torch.where(step < warmup, warm, cos)

    return lr
