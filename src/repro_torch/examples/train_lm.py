"""End-to-end driver: train a small LM for a few hundred steps with
checkpointing and a simulated mid-run node failure (recovery from the
latest snapshot) — the counterpart of the reference's
``examples/train_lm.py``.

    PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 300] \\
        [--arch glm4-9b] [--fail-at 150] [--device cpu]

It trains the reduced (smoke) variant of the chosen arch; the published
configs train through ``python -m repro_torch.launch.train``.
"""

from __future__ import annotations

import argparse
import tempfile

from ..configs import get_smoke_config
from ..launch.train import train_loop
from ..training import Hyper

__all__ = ["train", "main"]


def train(arch: str = "glm4-9b", steps: int = 300, fail_at: int = 150,
          device="cuda"):
    """``steps`` train steps of ``arch``'s smoke config at batch 8 x seq 32
    through ``launch.train.train_loop``, a snapshot every 50 steps in a
    temporary directory and a failure at step ``fail_at`` (-1: none).
    Returns ``(losses, recovery events)``."""
    cfg = get_smoke_config(arch)
    with tempfile.TemporaryDirectory() as ckpt_dir:
        fail = (fail_at,) if fail_at >= 0 else ()
        _, losses, events = train_loop(
            cfg, steps=steps, batch=8, seq=32,
            ckpt_dir=ckpt_dir, ckpt_every=50, fail_at=fail,
            hyper=Hyper(lr=1e-3, warmup=20, total_steps=steps),
            device=device)
    print(f"loss: {losses[0]:.3f} -> {losses[-1]:.3f} over {len(losses)} "
          "steps")
    for e in events:
        print(f"recovered at step {e.step}: {e.devices_before} -> "
              f"{e.devices_after} devices")
    if not losses[-1] < losses[0]:
        raise AssertionError("training failed to reduce loss")
    return losses, events


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="glm4-9b")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--fail-at", type=int, default=150,
                    help="simulate a node failure at this step (-1 = off)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    train(args.arch, args.steps, args.fail_at, args.device)
    print("train_lm complete")


if __name__ == "__main__":
    main()
