"""Quickstart: the paper's algorithm end to end — the counterpart of the
reference's ``examples/quickstart.py``.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

1. Sort a word list with the paper's pipeline (the distribute kernel builds
   the length buckets on the device -> OETS sort in each bucket -> shortlex
   order).
2. The same comparator network as the OETS row kernel (B1), one block a row
   at 256 columns, against the oracle.
3. Chunked ingest: stream words through fixed-size launches as sorted runs
   combined by the run merge (inputs beyond one launch).
4. The technique inside an LM: sort-based MoE dispatch on a tiny model.

Each demo returns what it computed; on the CPU the kernels' plain versions
run.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..configs import get_smoke_config
from ..core import bucketed_sort_words, pack_words
from ..data import synthetic_words
from ..interop import resolve_device, to_device
from ..kernels import bucketize, sort_rows, sort_rows_ref
from ..models import forward, init_lm
from ..parallel.sharding import Rules
from ..pipeline import chunked_sort_words

__all__ = ["demo_paper_pipeline", "demo_row_kernel", "demo_chunked_pipeline",
           "demo_moe_lm", "main"]

MOE_ARCH = "granite-moe-1b-a400m"


def _shortlex(words):
    return sorted(words, key=lambda w: (len(w), w))


def _check(ok: bool, what: str):
    if not ok:
        raise AssertionError(what)


def demo_paper_pipeline(device="cuda"):
    """2,000 synthetic words through ``bucketed_sort_words(algorithm=
    'oets')``; returns ``(sorted words, non-empty length buckets)``."""
    words = synthetic_words(2_000, seed=0)
    out = bucketed_sort_words(words, algorithm="oets", device=device)
    _check(out == _shortlex(words), "[1] bucketed OETS is not shortlex")
    counts = bucketize(to_device(pack_words(words), device)).counts
    n_buckets = int((counts > 0).sum())
    print(f"[1] bucketed OETS sorted {len(words)} words "
          f"({n_buckets} device-built length buckets) -> shortlex OK")
    return out, n_buckets


def demo_row_kernel(device="cuda"):
    """Each row of an (8, 256) int32 matrix sorted by the OETS row kernel,
    against ``sort_rows_ref``; returns the sorted rows."""
    rng = np.random.default_rng(0)
    x = to_device(rng.integers(0, 10**6, (8, 256)).astype(np.int32), device)
    out = sort_rows(x, algorithm="oets")
    _check(torch.equal(out, sort_rows_ref(x)),
           "[2] the OETS row kernel differs from the oracle")
    print(f"[2] OETS row kernel == sort_rows_ref oracle on (8,256) rows OK "
          f"({out.device.type})")
    return out


def demo_chunked_pipeline(device="cuda"):
    """600 words in chunks of 128, each a sorted run, merged; returns the
    merged words."""
    words = synthetic_words(600, seed=2)
    chunk = 128
    out = chunked_sort_words(words, chunk_size=chunk, device=device)
    _check(out == _shortlex(words), "[3] the chunked sort is not shortlex")
    n_runs = -(-len(words) // chunk)
    print(f"[3] chunked ingest: {len(words)} words -> {n_runs} sorted runs "
          f"(chunk={chunk}) -> merge-path combine -> shortlex OK")
    return out


def demo_moe_lm(device="cuda", lm=None, tokens=None):
    """Granite-MoE's smoke forward (the 'xla' dispatch) on a (2, 16) token
    batch. ``lm`` and ``tokens`` default to weights from seed 0 and tokens
    from a generator seeded 1, on ``device``; returns ``(logits, aux)``."""
    dev = resolve_device(device)
    cfg = get_smoke_config(MOE_ARCH)
    if lm is None:
        lm = init_lm(cfg, seed=0, device=dev)
    if tokens is None:
        gen = torch.Generator(device=dev).manual_seed(1)
        tokens = torch.randint(0, cfg.vocab_size, (2, 16), generator=gen,
                               device=dev, dtype=torch.int32)
    with torch.inference_mode():
        logits, aux, _ = forward(cfg, lm, {"tokens": to_device(tokens, dev)},
                                 Rules())
    print(f"[4] granite-moe forward with sort-based dispatch: "
          f"logits {tuple(logits.shape)}, aux-loss {float(aux):.4f} OK")
    return logits, aux


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    resolve_device(args.device)
    demo_paper_pipeline(args.device)
    demo_row_kernel(args.device)
    demo_chunked_pipeline(args.device)
    demo_moe_lm(args.device)
    print("quickstart complete")


if __name__ == "__main__":
    main()
