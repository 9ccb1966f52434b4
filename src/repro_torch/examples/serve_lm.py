"""Serve a small model with batched requests through the paper's
length-bucketed admission scheduler — the counterpart of the reference's
``examples/serve_lm.py``.

    PYTHONPATH=src python -m repro_torch.examples.serve_lm [--device cpu]

MiniCPM3's smoke config (MLA: compressed-latent decode); the admission
sort runs on the OETS row kernel (B1) on the card.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from ..configs import get_smoke_config
from ..interop import resolve_device
from ..models import init_lm
from ..parallel.sharding import Rules
from ..serve import BucketedScheduler, Engine, Request

__all__ = ["ARCH", "BOUNDS", "requests", "serve", "main"]

ARCH = "minicpm3-4b"
BOUNDS = [8, 16, 32, 48]


def requests(vocab_size: int):
    """24 requests of 3-47 tokens from ``default_rng(0)``, 8 new tokens
    each (the reference's draws, in its order)."""
    rng = np.random.default_rng(0)
    return [Request(f"req-{i}",
                    list(rng.integers(1, vocab_size,
                                      int(rng.integers(3, 48)))),
                    max_new=8)
            for i in range(24)]


def serve(device="cuda", lm=None):
    """Serve :func:`requests` through ``BucketedScheduler(Engine(...,
    max_seq=96), batch_size=8, bounds=BOUNDS)``; ``lm`` defaults to the
    smoke config's weights from seed 0 on ``device``. Returns ``(results,
    padding stats)``."""
    dev = resolve_device(device)
    cfg = get_smoke_config(ARCH)
    if lm is None:
        lm = init_lm(cfg, seed=0, device=dev)
    engine = Engine(cfg, lm, Rules(), max_seq=96)
    sched = BucketedScheduler(engine, batch_size=8, bounds=BOUNDS)
    reqs = requests(cfg.vocab_size)

    stats = BucketedScheduler.padding_stats(reqs, bounds=BOUNDS)
    print(f"padding waste: global-batch {stats['global_waste']:.1%} -> "
          f"bucketed {stats['bucketed_waste']:.1%}")

    t0 = time.time()
    results = sched.run(reqs)
    dt = time.time() - t0
    toks = sum(len(r.tokens) for r in results)
    print(f"served {len(results)} requests / {toks} tokens in {dt:.2f}s "
          f"({toks/dt:.1f} tok/s on {engine.device} smoke model)")
    sample = results[0]
    print(f"sample {sample.request_id}: {sample.tokens}")
    return results, stats


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    serve(args.device)
    print("serve_lm complete")


if __name__ == "__main__":
    main()
