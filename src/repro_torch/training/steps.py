"""Train and eval steps — the counterpart of ``repro.training.steps``.

``make_train_step`` returns

    train_step(lm, opt_state, batch, step) -> (lm, opt_state, metrics)

which updates ``lm``'s parameters and ``opt_state`` in place (the
reference's donated buffers) and returns them with ``{"ce", "aux", "loss",
"grad_norm", "lr"}``. The gradients come from ``torch.autograd.grad``, so
no ``.grad`` buffer outlives a step. With ``Hyper.accum > 1`` the batch is
split into ``accum`` equal microbatches along its first axis, as the
reference's ``lax.scan`` splits it: their gradients are added into float32
buffers in order and divided by ``accum``, their losses likewise, and
``aux`` is reported as zero — AdamW then gets float32 gradients, where with
``accum == 1`` it gets each parameter's own dtype, as in the reference.
"""

from __future__ import annotations

import dataclasses

import torch

from ..models.config import ModelConfig
from ..models.model import lm_loss
from ..optim import (AdamWConfig, adamw_update, clip_by_global_norm,
                     cosine_schedule)
from ..parallel.sharding import Rules

__all__ = ["Hyper", "make_train_step", "make_eval_step"]


@dataclasses.dataclass(frozen=True)
class Hyper:
    lr: float = 3e-4
    warmup: int = 100
    total_steps: int = 10_000
    clip_norm: float = 1.0
    accum: int = 1              # microbatch gradient accumulation factor
    adamw: AdamWConfig = dataclasses.field(default_factory=AdamWConfig)
    sort_impl: str = "xla"


def _split_microbatches(batch, accum: int):
    """``accum`` microbatches, each a dict of the batch's leaves sliced
    along their first axis."""
    def split(x):
        b = x.shape[0]
        if b % accum:
            raise ValueError(f"batch {b} not divisible by accum {accum}")
        return [x[i * (b // accum):(i + 1) * (b // accum)]
                for i in range(accum)]
    parts = {k: split(v) for k, v in batch.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(accum)]


def make_train_step(cfg: ModelConfig, rules: Rules, hyper: Hyper):
    schedule = cosine_schedule(hyper.lr, hyper.warmup, hyper.total_steps)

    def grads_of(lm, mb):
        names, params = zip(*lm.named_parameters())
        loss, metrics = lm_loss(cfg, lm, mb, rules, sort_impl=hyper.sort_impl)
        grads = torch.autograd.grad(loss, params)
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                dict(zip(names, grads)))

    def train_step(lm, opt_state, batch, step):
        if hyper.accum == 1:
            loss, metrics, grads = grads_of(lm, batch)
        else:
            grads, loss = None, None
            for mb in _split_microbatches(batch, hyper.accum):
                l, _, g = grads_of(lm, mb)
                if grads is None:
                    grads = {k: torch.zeros(v.shape, dtype=torch.float32,
                                            device=v.device)
                             for k, v in g.items()}
                    loss = torch.zeros((), dtype=torch.float32,
                                       device=l.device)
                torch._foreach_add_(list(grads.values()),
                                    [g[k] for k in grads])
                loss = loss + l
            grads = {k: v / hyper.accum for k, v in grads.items()}
            loss = loss / hyper.accum
            metrics = {"ce": loss, "aux": torch.zeros_like(loss)}
        grads, gnorm = clip_by_global_norm(grads, hyper.clip_norm)
        lr = schedule(step)
        adamw_update(grads, opt_state, lm, lr, hyper.adamw)
        metrics = dict(metrics, loss=loss, grad_norm=gnorm, lr=lr)
        return lm, opt_state, metrics

    return train_step


def make_eval_step(cfg: ModelConfig, rules: Rules, sort_impl: str = "xla"):
    @torch.no_grad()
    def eval_step(lm, batch):
        loss, metrics = lm_loss(cfg, lm, batch, rules, sort_impl=sort_impl)
        return dict(metrics, loss=loss)

    return eval_step
