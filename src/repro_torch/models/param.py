"""Parameter construction — the counterpart of ``repro.models.param``.

A :class:`Builder` draws every parameter from one explicit
``torch.Generator`` on one device, with the reference's init kinds:
'normal' (scaled by ``fan_in ** -0.5`` unless ``scale`` is given, the
fan-in being ``shape[-2]``, or ``shape[-1]`` for a vector), 'zeros', 'ones'
and 'ssm_a' (Mamba's ``A_log``: the log of Uniform[1, 16]). Draws are made
in float32 and cast to the parameter dtype. On the ``meta`` device it
allocates and draws nothing — the reference's ``abstract=True`` — which is
how weights carried over from the reference are loaded without a random
init first (``interop.lm_from_reference``).

The port's draws are not JAX's: the same seed gives other weights in the
two packages. Tests that compare them carry the reference's weights across.
"""

from __future__ import annotations

import torch

__all__ = ["Builder"]

_INITS = ("normal", "zeros", "ones", "ssm_a")


class Builder:
    """Creates parameter tensors on ``device`` in ``dtype`` from
    ``generator`` (a ``torch.Generator`` on that device; ``None`` is
    allowed on the ``meta`` device, which draws nothing)."""

    def __init__(self, generator: torch.Generator | None,
                 dtype=torch.float32, device="cpu"):
        self.generator = generator
        self.dtype = dtype
        self.device = torch.device(device)

    @property
    def abstract(self) -> bool:
        return self.device.type == "meta"

    def param(self, shape, init: str = "normal", scale: float | None = None,
              dtype=None) -> torch.nn.Parameter:
        if init not in _INITS:
            raise ValueError(f"unknown init {init!r}")
        dtype = dtype or self.dtype
        shape = tuple(shape)
        dev, gen = self.device, self.generator
        if self.abstract:
            v = torch.empty(shape, dtype=dtype, device=dev)
        elif init == "normal":
            if scale is None:
                fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
                scale = fan_in ** -0.5
            v = (scale * torch.randn(shape, generator=gen, device=dev)
                 ).to(dtype)
        elif init == "zeros":
            v = torch.zeros(shape, dtype=dtype, device=dev)
        elif init == "ones":
            v = torch.ones(shape, dtype=dtype, device=dev)
        else:                              # ssm_a: log of Uniform[1, 16]
            u = torch.rand(shape, generator=gen, device=dev)
            v = torch.log(1.0 + 15.0 * u).to(dtype)
        return torch.nn.Parameter(v, requires_grad=False)
