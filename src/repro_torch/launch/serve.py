"""Serving from the command line: an :class:`~repro_torch.serve.Engine`
behind the paper's length-bucketed scheduler, on synthetic requests and
random weights from a seed.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-moe-1b-a400m
    PYTHONPATH=src python -m repro_torch.launch.serve --arch minicpm3-4b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b --smoke --device cpu

Every token arch serves: GQA, MLA, MoE, the Mamba2 SSM and the Zamba2
hybrid. The two frames archs (qwen2-vl-2b, musicgen-large) are refused, as
the reference's launcher refuses them. It runs the published configuration
unless ``--smoke`` is given, on the card unless ``--device cpu`` is given
(without a card the default raises). ``--sort-impl pallas`` sends the MoE
dispatch through the hand-written kernels.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from ..configs import get_config, get_smoke_config
from ..models.model import init_lm
from ..parallel.sharding import Rules
from ..serve import BucketedScheduler, Engine, Request

__all__ = ["main"]


def main(argv=None):
    """The command line's run; returns the scheduler's results (one
    ``GenerationResult`` a request, in admission order)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--sort-impl", default="xla",
                    choices=("xla", "oets", "bitonic", "pallas"))
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.input_kind != "tokens":
        raise SystemExit("serving takes token archs (the frames "
                         "archs' front ends are stubs that give embeddings, "
                         "not token streams)")
    lm = init_lm(cfg, seed=0, device=args.device)
    engine = Engine(cfg, lm, Rules(), max_seq=args.max_seq,
                    sort_impl=args.sort_impl)
    sched = BucketedScheduler(engine, batch_size=8)

    rng = np.random.default_rng(0)
    reqs = [Request(i, list(rng.integers(1, cfg.vocab_size,
                                         rng.integers(4, 48))),
                    max_new=args.max_new)
            for i in range(args.requests)]
    t0 = time.time()
    results = sched.run(reqs)
    dt = time.time() - t0
    gen = sum(len(r.tokens) for r in results)
    print(f"{len(results)} requests, {gen} tokens in {dt:.2f}s "
          f"({gen / dt:.1f} tok/s) on {engine.device}")
    print("padding waste:",
          BucketedScheduler.padding_stats(reqs, bounds=[8, 16, 32, 48]))
    return results


if __name__ == "__main__":
    main()
