"""Shared by the parallel plan's tests (``test_torch_plan.py``): the smoke
configs and inputs of each case, and the weights, drawn with numpy from a
seed in the reference's layout, so that the reference's 8-device
subprocess and every port rank start from the same arrays without either
waiting for the other."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.interop import named_to_reference
from repro_torch.models.model import init_lm

MESH = ((4, 2), ("data", "model"))     # the reference's (data, model) mesh
RESHARD_MESH = ((2, 4), ("data", "model"))
FORWARD_ARCHS = ("glm4-9b", "granite-moe-1b-a400m", "minicpm3-4b",
                 "zamba2-1.2b")
DECODE_ARCHS = ("glm4-9b", "granite-moe-1b-a400m")
TRAIN_ARCH = "granite-moe-1b-a400m"
REMATS = ("none", "full", "dots")
B, S, DECODE_STEPS = 8, 16, 4
HYPER = dict(lr=1e-3, warmup=1, total_steps=5)
EP_T = 64
# one train step sharded against unsharded (the training tests' bounds):
# the loss and gradient norm relative; each element's change from the
# initial weights absolute, where the step at ``HYPER``'s lr moves an
# element by about 1e-3 (AdamW's first update is lr * sign(g)), so that at
# most ``DELTA_OUTLIERS`` elements may be off (a gradient element near 0
# may change sign between two summation orders), by at most 2 * lr; the
# moments relative to each leaf's largest
LOSS_RTOL, GNORM_RTOL = 1e-5, 1e-4
DELTA_ATOL, DELTA_OUTLIERS, MOMENT_RTOL = 5e-5, 8, 1e-3


def weights(arch: str, seed: int = 0) -> dict:
    """The float32 weights of ``arch``'s smoke config as the reference's
    nested dict of numpy arrays: matrices normal with a ``fan_in ** -0.5``
    scale, norms and ``D`` near one, ``A_log`` the log of Uniform[1, 16],
    other vectors small."""
    rng = np.random.default_rng(seed)
    named = {}
    for name, p in init_lm(get_smoke_config(arch), device="meta") \
            .named_parameters():
        shape, leaf = tuple(p.shape), name.rsplit(".", 1)[-1]
        if leaf == "A_log":
            a = np.log(rng.uniform(1.0, 16.0, shape))
        elif len(shape) >= 2:
            a = rng.normal(size=shape) * shape[-2] ** -0.5
        elif leaf in ("w", "norm_w", "D"):
            a = 1.0 + 0.1 * rng.normal(size=shape)
        else:
            a = 0.1 * rng.normal(size=shape)
        named[name] = torch.from_numpy(a.astype(np.float32))
    return named_to_reference(named)


def batch(cfg, seed: int = 1) -> dict:
    """Tokens ``(B, S)`` and labels (the last two positions masked)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels[:, -2:] = -1
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S))
            .astype(np.int32), "labels": labels}


def ep_config():
    """Granite's smoke config with 8 experts, one a rank, top-2 and
    capacity high enough that nothing drops (the reference's
    ``tests/test_moe_ep.py``)."""
    cfg = get_smoke_config("granite-moe-1b-a400m")
    return cfg.replace(moe=dataclasses.replace(
        cfg.moe, n_experts=8, top_k=2, capacity_factor=8.0, n_shared=0))


def ep_inputs(seed: int = 2) -> dict:
    """Tokens ``(EP_T, d)``, the router and the experts of
    :func:`ep_config`."""
    cfg = ep_config()
    m, dm = cfg.moe, cfg.d_model
    rng = np.random.default_rng(seed)

    def normal(*shape, scale):
        return (rng.normal(size=shape) * scale).astype(np.float32)
    return {"x": normal(EP_T, dm, scale=1.0),
            "router": normal(dm, m.n_experts, scale=dm ** -0.5),
            "w_in": normal(m.n_experts, dm, 2 * m.d_expert, scale=dm ** -0.5),
            "w_out": normal(m.n_experts, m.d_expert, dm,
                            scale=m.d_expert ** -0.5)}


def collective_inputs(seed: int = 0) -> dict:
    """The reference's multi-device suite's inputs
    (``tests/test_parallel.py``): ``y`` (8, 32) one row a rank, eight
    pipeline stages ``ws`` (8, 4, 4) and five microbatches ``mbs`` (5, 3,
    4)."""
    rng = np.random.default_rng(seed)
    return {"y": rng.normal(size=(8, 32)).astype(np.float32),
            "ws": (rng.normal(size=(8, 4, 4)) * 0.5).astype(np.float32),
            "mbs": rng.normal(size=(5, 3, 4)).astype(np.float32)}


def assert_step_matches(init: dict, want: dict, got: dict) -> None:
    """One train step's results ``got`` (sharded) against ``want``
    (unsharded), both from the weights ``init`` (``{name: array}``); each
    a dict of numpy arrays ``loss``, ``grad_norm``, ``lr`` and
    ``param/<name>``, ``m/<name>``, ``v/<name>`` after the step."""
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                               rtol=GNORM_RTOL)
    lr = float(want["lr"])
    assert float(got["lr"]) == lr and DELTA_ATOL < lr / 10
    assert init and set(got) == set(want) == {
        f"{part}/{k}" for part in ("param", "m", "v") for k in init} | {
        "loss", "grad_norm", "lr"}
    outliers = moved = size = 0
    for k, w0 in init.items():
        d_want = want[f"param/{k}"] - w0
        err = np.abs((got[f"param/{k}"] - w0) - d_want)
        assert err.max() <= 2 * lr * 1.01, k
        outliers += int((err > DELTA_ATOL).sum())
        moved += int((np.abs(d_want) > DELTA_ATOL).sum())
        size += err.size
        for mom in ("m", "v"):
            ref = want[f"{mom}/{k}"]
            np.testing.assert_allclose(got[f"{mom}/{k}"], ref, rtol=0,
                                       atol=MOMENT_RTOL * np.abs(ref).max(),
                                       err_msg=f"{mom}/{k}")
    assert outliers <= DELTA_OUTLIERS, outliers
    assert moved > size / 2, (moved, size)    # the step moved the weights
