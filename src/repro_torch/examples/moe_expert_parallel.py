"""The paper's technique at mesh scale inside a model: explicit
expert-parallel MoE dispatch (sort -> bucket -> ONE all_to_all -> local
experts -> return) across 8 ranks, checked against the one-device ``moe``
— the counterpart of the reference's ``examples/moe_expert_parallel.py``.

    PYTHONPATH=src python -m repro_torch.examples.moe_expert_parallel [--device cpu]

It starts its 8 ranks itself (``_ranks.run_ranks``): processes of one gloo
group, all on ``cuda:0`` of one card, or on the CPU with ``--device cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses

import torch
import torch.distributed as dist

from ..configs import get_smoke_config
from ..interop import to_device, to_numpy
from ..models.moe import init_moe, moe
from ..models.moe_ep import ep_moe
from ..models.param import Builder
from ..parallel.compat import make_mesh
from ..parallel.sharding import Rules
from ._ranks import run_ranks

__all__ = ["EP_ATOL", "TOKENS", "config", "rank_demo", "main"]

TOKENS = 64
EP_ATOL = 2e-4          # the reference's bound


def config():
    """Granite's smoke config with 8 experts, top-2, capacity factor 8 (no
    token drops) and no shared experts."""
    cfg = get_smoke_config("granite-moe-1b-a400m")
    return cfg.replace(moe=dataclasses.replace(
        cfg.moe, n_experts=8, top_k=2, capacity_factor=8.0, n_shared=0))


def rank_demo(device, weights=None):
    """One rank's part (every rank of the default process group calls it):
    ``moe`` on the rank's device against ``ep_moe`` over an ``("ep",)``
    mesh of all ranks, on 64 tokens. ``weights`` — ``{"router", "w_in",
    "w_out", "x"}`` as numpy arrays — default to float32 weights from a
    ``torch.Generator`` seeded 0 and tokens from one seeded 1. Returns
    ``{"y_ep", "y_moe", "err"}``."""
    device = torch.device(device)
    cfg = config()
    if weights is None:
        gen = torch.Generator(device=device).manual_seed(0)
        p = init_moe(Builder(gen, dtype=torch.float32, device=device), cfg)
        gen = torch.Generator(device=device).manual_seed(1)
        x = torch.randn((1, TOKENS, cfg.d_model), generator=gen,
                        device=device)
    else:
        p = init_moe(Builder(None, dtype=torch.float32, device="meta"), cfg)
        for name in ("router", "w_in", "w_out"):
            setattr(p, name, torch.nn.Parameter(
                to_device(weights[name], device)))
        x = to_device(weights["x"], device).reshape(1, TOKENS, cfg.d_model)

    with torch.no_grad():
        y_ref, _ = moe(cfg, p, x, Rules())
        mesh = make_mesh((dist.get_world_size(),), ("ep",), device.type)
        y_ep, _ = ep_moe(cfg, mesh, "ep", x.reshape(TOKENS, cfg.d_model),
                         p.router, p.w_in, p.w_out)
        y_ep = to_numpy(y_ep).reshape(1, TOKENS, -1)
    y_ref = to_numpy(y_ref)
    err = float(abs(y_ep - y_ref).max())
    if dist.get_rank() == 0:
        print(f"{mesh.size()}-way expert-parallel dispatch (1 expert/device, "
              f"sort-bucketed, one all_to_all each way)\n"
              f"max |EP - moe| = {err:.2e}", flush=True)
    if not err < EP_ATOL:
        raise AssertionError(f"max |EP - moe| = {err} is not under "
                             f"{EP_ATOL}")
    return {"y_ep": y_ep, "y_moe": y_ref, "err": err}


def main(argv=None):
    """Run :func:`rank_demo` in 8 ranks; returns ``run_ranks``' list of
    each rank's ``(outputs, kernel launches)``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    ranks = run_ranks(rank_demo, args.device)
    print("moe_expert_parallel complete")
    return ranks


if __name__ == "__main__":
    main()
