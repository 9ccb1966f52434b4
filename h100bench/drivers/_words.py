"""What the word-sort drivers share: a pool of corpora made in set-up, a
closed loop of one client that sorts them in turn (each call timed on the
host clock from the call to the ``torch.cuda.synchronize()`` after it), and
the check of a sample of the window's answers, drawn from the seed,
against the shortlex reference once the window has closed.

A driver gives ``call(keys, device) -> (lengths, keys, packed lanes)``;
the answers stay on the device until the check.
"""

from __future__ import annotations

import sys
import time

import numpy as np

from ..reference import shortlex
from ..traffic import words


def sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def setup(cell, seed: int, device, call):
    mix, cfg = cell.traffic, cell.config
    max_len = cfg["max_word_len"]
    pool = [words.corpus(mix["words"], seed, k, max_len, device=device)
            for k in range(mix["pool"])]
    # warm every corpus of the pool once: the kernels load (the first run
    # of a checkout builds them) and the allocator holds the call's blocks
    t_warm = []
    for keys, _ in pool:
        t0 = time.perf_counter()
        call(keys, device)
        sync(device)
        t_warm.append(time.perf_counter() - t0)
    return {"cell": cell, "seed": seed, "device": device, "call": call,
            "pool": pool, "warm_s": min(t_warm)}


def window(state, win, spans) -> dict:
    cell, device = state["cell"], state["device"]
    spec, pool, call = cell.spec, state["pool"], state["call"]
    n = cell.traffic["words"]
    # the calls whose answers the check compares: each with the same
    # chance, set so that about ``sample`` fall in the window
    expected = max(1.0, win.limit / state["warm_s"])
    p_keep = min(1.0, spec["sample"] / expected)
    rng = np.random.default_rng([state["seed"] % (1 << 63), 7])
    times, kept, failed, last = [], [], 0, None
    for i in win:
        c = i % len(pool)
        t0 = time.perf_counter()
        t0_ns = time.time_ns()
        try:
            out = call(pool[c][0], device)
            sync(device)
        except RuntimeError as e:
            failed += 1
            print(f"call {i} failed: {e}", file=sys.stderr)
            continue
        finally:
            spans.add("sort call", t0_ns, time.time_ns())
        times.append(time.perf_counter() - t0)
        last = (c, out)
        if rng.random() < p_keep and len(kept) < spec["sample_max"]:
            kept.append(last)
    if not kept and last is not None:
        kept.append(last)
    state["kept"] = kept
    calls = win.units
    lanes = pool[0][0].shape[1]
    metrics = {}
    if times:
        metrics = {"words_per_s": len(times) * n / win.seconds,
                   "sort_ms_p95": _p95_ms(times)}
    packed = last[1][2] if last is not None and last[1][2] else ()
    return {"attempted": calls, "failed": failed, "metrics": metrics,
            "calls": len(times),
            "per_unit": [{"calls": 1}] * len(times),
            # the least bytes of a call: each word's key lanes read once,
            # its length, sorted lanes and packed rank-key lanes (where the
            # entry returns them) written once
            "least_bytes_per_call": n * (4 * lanes + 4 + 4 * lanes
                                         + 4 * len(packed))}


def _p95_ms(times) -> float:
    from ..bench import percentile
    return 1e3 * percentile(times, 95)


def check(state, records) -> list:
    """``[(name, value, limit)]``: the rows of the sampled answers that
    differ from the reference's, their packed rank keys where the workload
    compares them (the entry returns them), and the calls that failed."""
    limits = state["cell"].spec["limits"]
    kept = [(c, tuple(_host(x) for x in out)) for c, out in state["kept"]]
    state.pop("kept")
    refs, rows, packed = {}, 0, 0
    for c, (lens, keys, lanes) in kept:
        if c not in refs:
            want_keys, want_lens = state["pool"][c]
            want = shortlex.sort(want_lens, want_keys)
            refs[c] = want, shortlex.pack(*want)
        (want_lens, want_keys), want_packed = refs[c]
        rows += shortlex.rows_off(want_lens, want_keys, lens, keys)
        packed += shortlex.packed_off(want_packed, lanes)
    numbers = [("answers_compared", len(kept), None),
               ("rows_off", rows, limits["rows_off"])]
    if "packed_off" in limits:
        numbers.append(("packed_off", packed, limits["packed_off"]))
    return numbers + [("calls_failed", records["failed"], 0)]


def control(state):
    """Put the check's control in the program's place after set-up: the
    reference's sort with the key lanes compared as float32
    (:func:`shortlex.control_sort`), its packed rank keys computed from
    that order."""
    def call(keys, device):
        lens, out = shortlex.control_sort(words.byte_lengths(keys), keys)
        return lens, out, shortlex.pack(lens, out)
    state["call"] = call


def _host(x):
    import torch
    if x is None:
        return None
    if isinstance(x, (tuple, list)):
        return tuple(_host(a) for a in x)
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.uint32:
            x = x.view(torch.int32).cpu().numpy().view(np.uint32)
        else:
            x = x.cpu().numpy()
    return np.asarray(x)
