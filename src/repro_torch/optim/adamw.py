"""AdamW with explicit state — the counterpart of ``repro.optim.adamw``.

The state is the reference's: ``{"m", "v", "count"}``, the moments one
tensor a parameter (named as the LM's ``named_parameters``) in the dtype
the caller gives (bf16 moments halve the optimizer's memory, the
reference's trick for its largest configs), ``count`` an int32 scalar. The
update is computed in float32 and cast back to each parameter's and
moment's dtype, as the reference's; it is applied in place under
``torch.no_grad()``, which stands for the reference's donated buffers.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

__all__ = ["AdamWConfig", "init_opt_state", "adamw_update", "opt_state_axes"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1


def _named(params) -> dict:
    """``{name: tensor}`` of an ``nn.Module``'s parameters, or ``params``
    itself where it is that dict already."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return params


def init_opt_state(params, moment_dtype=torch.float32) -> dict:
    """Zero moments like each parameter of ``params`` (an ``nn.Module`` or
    a dict of tensors), in ``moment_dtype`` and placed as the parameter
    where it is a ``DTensor``, and ``count`` 0 (a plain tensor)."""
    named = _named(params)
    device = next(iter(named.values())).device

    def zeros():
        # torch.zeros_like keeps a DTensor parameter's mesh and placements
        return {k: torch.zeros_like(p, dtype=moment_dtype,
                                    requires_grad=False)
                for k, p in named.items()}
    return {"m": zeros(), "v": zeros(),
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def opt_state_axes(param_axes):
    """Moments shard like their parameters; count is replicated."""
    return {"m": param_axes, "v": param_axes, "count": ()}


@torch.no_grad()
def adamw_update(grads, state, params, lr, cfg: AdamWConfig):
    """One AdamW step: ``params`` (an ``nn.Module`` or a dict of tensors)
    and ``state`` updated in place from ``grads`` (a dict named as the
    parameters) at learning rate ``lr`` (a float or a 0-d tensor).
    Returns ``(params, state)``."""
    named = _named(params)
    lr = float(lr)
    count = state["count"] + 1
    c = count.float()
    bc1 = 1.0 - cfg.b1 ** c
    bc2 = 1.0 - cfg.b2 ** c
    m_all, v_all = state["m"], state["v"]
    for k, p in named.items():
        g32 = grads[k].float()
        m, v = m_all[k], v_all[k]
        m32 = m.float() * cfg.b1 + g32 * (1.0 - cfg.b1)
        v32 = v.float() * cfg.b2 + g32 * g32 * (1.0 - cfg.b2)
        step = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps)
        step = step + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * step)
        m.copy_(m32)
        v.copy_(v32)
    state["count"] = count
    return params, state
