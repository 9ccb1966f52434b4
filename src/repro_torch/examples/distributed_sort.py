"""The paper's algorithm at mesh scale: the multi-engine distributed sort
(``core.distributed``) over 8 gloo ranks — odd-even block sort (bubble
sort over the interconnect), splitter sample sort (the paper's distribute
step as ONE all_to_all), and the multi-host word pipeline: bucketize by
length -> shard -> distributed lex sort -> shortlex concat. The counterpart
of the reference's ``examples/distributed_sort.py``.

    PYTHONPATH=src python -m repro_torch.examples.distributed_sort [--device cpu]

It starts its 8 ranks itself (``_ranks.run_ranks``): processes of one gloo
group, all on ``cuda:0`` of one card, or on the CPU with ``--device cpu``.
Rank 0 prints the demos' lines.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.distributed as dist

from ..core import packing
from ..core.distributed import (choose_engine, distributed_sort,
                                distributed_sort_lex)
from ..interop import to_device, to_numpy
from ..kernels import sort_lex
from ..parallel.compat import make_mesh
from ._ranks import run_ranks

__all__ = ["engines_demo", "word_pipeline_demo", "kv_demo", "lex_demo",
           "rank_demos", "main"]


def _check(ok: bool, what: str):
    if not ok:
        raise AssertionError(what)


def _say(text: str):
    if dist.get_rank() == 0:
        print(text, flush=True)


def engines_demo(mesh, device):
    """Both mesh engines against the ``np.sort`` oracle — including a
    non-divisible size (8 ranks, n % 8 != 0: pad-and-slice, no error).
    Returns ``{"<engine>-<merge>-<n>": sorted keys}``."""
    rng = np.random.default_rng(0)
    out = {}
    for n in (8 * 4096, 10_001):
        x = rng.integers(0, 10**9, n).astype(np.int32)
        want = np.sort(x)
        for merge in ("resort", "bitonic", "take"):
            got = to_numpy(distributed_sort(x, mesh, engine="odd_even",
                                            merge=merge, device=device))
            ok = bool((got == want).all())
            _say(f"odd-even  n={n:7d} merge={merge:8s}: "
                 f"{'OK' if ok else 'FAIL'}")
            _check(ok, f"odd-even n={n} merge={merge}")
            out[f"odd_even-{merge}-{n}"] = got
        got = to_numpy(distributed_sort(x, mesh, engine="sample",
                                        device=device))
        ok = bool((got == want).all())
        _say(f"sample    n={n:7d} one all_to_all  : {'OK' if ok else 'FAIL'}")
        _check(ok, f"sample n={n}")
        out[f"sample-{n}"] = got
    _say(f"choose_engine: P=2 -> {choose_engine(2, 4096)}, "
         f"P=8 -> {choose_engine(8, 4096)}")
    return out


def word_pipeline_demo(mesh, device):
    """The paper's whole pipeline across the mesh: words bucketize by length
    (the length becomes lex lane 0), pack into big-endian uint32 lanes
    (``core.packing``), shard over the ranks, and ONE distributed lex sort
    returns shortlex order. Returns the sorted words."""
    rng = np.random.default_rng(7)
    alphabet = np.array(list("abcdefghij"))
    words = ["".join(rng.choice(alphabet, rng.integers(1, 8)))
             for _ in range(1003)]  # non-divisible on purpose

    packed = packing.pack_words(words)             # (n, lanes) uint32
    length = np.asarray([len(w) for w in words], np.int32)
    lanes = [length] + [packed[:, l] for l in range(packed.shape[1])]
    out = distributed_sort_lex(lanes, mesh, engine="sample", device=device)
    got = packing.unpack_words(np.stack([to_numpy(o) for o in out[1:]],
                                        axis=1))
    ok = got == sorted(words, key=lambda w: (len(w), w))
    _say(f"word pipeline: {len(words)} words -> distributed shortlex over "
         f"{mesh.size()} devices: {'OK' if ok else 'FAIL'}")
    _check(ok, "word pipeline")
    return got


def kv_demo(mesh, device):
    """Payload lanes ride the splitter exchange: sort (key, row-id) pairs so
    the permutation can gather any satellite data afterwards. Returns the
    sorted ``(keys, payload)``."""
    rng = np.random.default_rng(3)
    k = rng.integers(0, 50, 999).astype(np.int32)
    v = np.arange(999, dtype=np.int32)
    (ok_,), ov = distributed_sort_lex((k,), mesh, vals=v, engine="sample",
                                      device=device)
    ok_, ov = to_numpy(ok_), to_numpy(ov)
    good = sorted(zip(k.tolist(), v.tolist())) == \
        list(zip(ok_.tolist(), ov.tolist()))
    _say(f"kv payload through the exchange protocol: "
         f"{'OK' if good else 'FAIL'}")
    _check(good, "kv payload")
    return ok_, ov


def lex_demo(device):
    """64-bit keys as (hi, lo) uint32 lanes through single-device
    ``sort_lex`` — the same variadic engine the distributed tier runs per
    rank. Returns the sorted keys as uint64."""
    rng = np.random.default_rng(1)
    full = rng.integers(0, 1 << 63, 250, dtype=np.uint64)
    hi = to_device((full >> np.uint64(32)).astype(np.uint32), device)
    lo = to_device((full & np.uint64(0xFFFFFFFF)).astype(np.uint32), device)
    shi, slo = sort_lex([hi, lo])
    got = (to_numpy(shi).astype(np.uint64) << np.uint64(32)) | to_numpy(slo)
    ok = bool((got == np.sort(full)).all())
    print(f"sort_lex over 2 x uint32 lanes == uint64 sort:   "
          f"{'OK' if ok else 'FAIL'}", flush=True)
    _check(ok, "sort_lex over 2 lanes")
    return got


def rank_demos(device):
    """One rank's part (every rank of the default process group calls it):
    the mesh demos over a ``("data",)`` mesh of all ranks, then, on rank 0,
    :func:`lex_demo`. Returns ``{demo: output}``."""
    device = torch.device(device)
    mesh = make_mesh((dist.get_world_size(),), ("data",), device.type)
    out = {"engines": engines_demo(mesh, device),
           "words": word_pipeline_demo(mesh, device),
           "kv": kv_demo(mesh, device)}
    if dist.get_rank() == 0:
        out["lex"] = lex_demo(device)
    return out


def main(argv=None):
    """Run :func:`rank_demos` in 8 ranks; returns ``run_ranks``' list of
    each rank's ``(outputs, kernel launches)``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    ranks = run_ranks(rank_demos, args.device)
    print("distributed_sort complete")
    return ranks


if __name__ == "__main__":
    main()
