"""Training steps of the port — the counterpart of ``repro.training``:
loss, gradients, clipping and AdamW, with microbatch gradient
accumulation."""

from .steps import Hyper, make_eval_step, make_train_step

__all__ = ["Hyper", "make_train_step", "make_eval_step"]
