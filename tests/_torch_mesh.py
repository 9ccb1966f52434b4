"""Shared by the port's mesh tests: the inputs of the distributed-sort cases
(numpy only, so a reference subprocess and every port rank build the same
arrays from one seed), the launch of the reference on 8 fake XLA devices,
and the launch of N port ranks over gloo.

Ranks rendezvous through a ``FileStore`` in the test's own directory (a
fixed TCP port would collide between xdist workers), cap their threads at
one (8 ranks under 6 workers would oversubscribe the CPUs), write their
output to files there, and are killed when the launch's timeout passes, so
a dead rank fails its test instead of stalling the suite.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
TESTS = Path(__file__).resolve().parent

# the preamble of a port rank: argv is (rank, world, workdir)
RANK_PREAMBLE = r"""
import datetime, os, sys
rank, world, workdir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
import torch
import torch.distributed as dist
torch.set_num_threads(1)
dist.init_process_group(
    "gloo", init_method="file://" + os.path.join(workdir, "rendezvous"),
    rank=rank, world_size=world, timeout=datetime.timedelta(seconds=90))
"""


def _env():
    return dict(os.environ,
                PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(TESTS)]),
                OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")


def run_reference(script: str, args=(), timeout: float = 300) -> str:
    """``script`` in a fresh interpreter with 8 fake XLA CPU devices (the
    reference tests' pattern); returns its stdout, fails on a non-zero
    exit."""
    env = _env()
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    out = subprocess.run([sys.executable, "-c", script, *map(str, args)],
                         capture_output=True, text=True, env=env,
                         timeout=timeout)
    assert out.returncode == 0, out.stderr[-4000:]
    return out.stdout


def launch_ranks(script: str, world: int, workdir: Path,
                 timeout: float = 240) -> None:
    """Start ``world`` ranks of ``RANK_PREAMBLE + script`` and join them
    all within ``timeout`` seconds; kill every rank and fail when one
    fails or the time runs out. Each rank's output goes to
    ``workdir/rank<r>.log``."""
    workdir = Path(workdir)
    logs = [open(workdir / f"rank{r}.log", "w") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK_PREAMBLE + script, str(r), str(world),
         str(workdir)], stdout=logs[r], stderr=subprocess.STDOUT,
        env=_env()) for r in range(world)]
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(0.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        tail = (workdir / f"rank{bad[0]}.log").read_text()[-4000:]
        raise AssertionError(f"ranks {bad} failed (codes "
                             f"{[procs[r].returncode for r in bad]}):\n{tail}")


# ---------------------------------------------------------------------------
# the distributed-sort cases: (name, key lanes, vals or None, kwargs)
# ---------------------------------------------------------------------------

SIZES = (8 * 4096, 10_001, 13)   # divisible, not divisible, n < 8 P


def _int_inputs(rng, n):
    yield "random", rng.integers(-10**6, 10**6, n).astype(np.int32)
    yield "dup", rng.integers(0, 5, n).astype(np.int32)
    s = np.full(n, np.iinfo(np.int32).max, np.int32)
    s[: n // 2] = rng.integers(0, 100, n // 2)
    yield "sentinel", s
    yield "skew", np.full(n, 42, np.int32)


def engine_cases():
    """Every host-facing case, in a fixed order (one seed for all)."""
    rng = np.random.default_rng(0)
    for n in SIZES:
        for tag, x in _int_inputs(rng, n):
            for merge in ("resort", "bitonic", "take"):
                yield (f"odd_even-{merge}-{tag}-{n}", [x], None,
                       dict(engine="odd_even", merge=merge))
            yield f"sample-{tag}-{n}", [x], None, dict(engine="sample")
            yield f"auto-{tag}-{n}", [x], None, dict(engine="auto")
    engines = ("odd_even", "sample")
    # kv: the values ride the keys' permutation as the final tie-break
    k = rng.integers(0, 7, 10_001).astype(np.uint32)
    v = np.arange(10_001, dtype=np.uint32)
    for eng in engines:
        yield f"kv-{eng}", [k], v, dict(engine=eng)
    # 2 x uint32 lanes, one uint64 key; real uint32 max in both lanes
    full = rng.integers(0, 1 << 63, 999, dtype=np.uint64)
    full[::11] = np.uint64(0xFFFFFFFFFFFFFFFF)
    hi = (full >> np.uint64(32)).astype(np.uint32)
    lo = (full & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    for eng in engines:
        yield f"lex2-{eng}", [hi, lo], None, dict(engine=eng)
    # 3-lane lex tuples of mixed types, duplicate-heavy leading lanes
    a = rng.integers(0, 3, 8 * 4096).astype(np.uint32)
    b = rng.integers(-2, 2, 8 * 4096).astype(np.int32)
    c = rng.integers(0, 1 << 32, 8 * 4096, dtype=np.uint64).astype(np.uint32)
    for eng, merge in (("odd_even", "bitonic"), ("odd_even", "take"),
                       ("odd_even", "resort"), ("sample", "bitonic")):
        yield f"lex3-{eng}-{merge}", [a, b, c], None, dict(engine=eng,
                                                           merge=merge)
    # float lanes: +-inf through the sample exchange, and NaN payloads,
    # -0.0 and +-inf beside a distinct payload under validate='full'
    f = rng.normal(size=555).astype(np.float32)
    f[::7], f[1::9] = np.inf, -np.inf
    yield "float-inf-sample", [f], None, dict(engine="sample")
    x = rng.normal(scale=4.0, size=8 * 64).astype(np.float32)
    x[rng.random(x.size) < 0.15] = np.nan
    x[rng.random(x.size) < 0.10] = np.float32(-0.0)
    x[rng.random(x.size) < 0.10] = np.inf
    x[rng.random(x.size) < 0.05] = -np.inf
    pats = np.array([0x7FC00001, 0xFFC00000, 0x7F800001],
                    np.uint32).view(np.float32)
    mask = rng.random(x.size) < 0.10
    x[mask] = pats[rng.integers(0, len(pats), int(mask.sum()))]
    pay = np.arange(x.size, dtype=np.uint32)
    for eng in engines:
        yield f"float-nan-{eng}", [x], pay, dict(engine=eng, validate="full")
    # capacity: all-equal keys route every element to one destination;
    # capacity 64 < B = 512 overflows
    skew = np.full(8 * 512, 7, np.int32)
    for policy in ("raise", "retry", "clip"):
        yield (f"overflow-{policy}", [skew], None,
               dict(engine="sample", capacity=64, on_overflow=policy))
    # the gate, and the local-sort choices
    r = rng.integers(0, 10**6, 8 * 64).astype(np.int32)
    for eng in engines:
        for mode in ("cheap", "full"):
            yield f"validate-{mode}-{eng}", [r], None, dict(engine=eng,
                                                           validate=mode)
        for local in ("pallas", "xla"):
            yield (f"local-{local}-{eng}", [r], None,
                   dict(engine=eng, merge="resort", local_sort=local))


def protocol_cases():
    """Inputs of the SPMD exchange-protocol cases, each ``(name, block
    (8*B,), capacity)``: sentinel-valued reals, +inf, and overflow."""
    rng = np.random.default_rng(0)
    u = np.full(8 * 64, np.iinfo(np.uint32).max, np.uint32)
    u[:100] = rng.integers(0, 50, 100)
    f = rng.normal(size=8 * 32).astype(np.float32)
    f[::3] = np.inf
    i = np.full(8 * 32, np.iinfo(np.int32).max, np.int32)
    return [("uint32-max", u, None), ("float-inf", f, None),
            ("int32-max", i, None),
            ("overflow", np.full(8 * 64, 7, np.int32), 8),
            ("skew-default", np.full(8 * 64, 7, np.int32), None)]


def has_float(lanes, vals) -> bool:
    return any(np.asarray(a).dtype == np.float32
               for a in list(lanes) + ([] if vals is None else [vals]))


def odd_even_input():
    """The SPMD odd-even engine's input: 8 blocks of 64 duplicate-heavy
    int32 keys, ``iinfo.max`` among them."""
    rng = np.random.default_rng(3)
    x = rng.integers(-20, 20, 8 * 64).astype(np.int32)
    x[::13] = np.iinfo(np.int32).max
    return x
