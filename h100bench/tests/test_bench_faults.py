"""Whole runs on the CPU, the look for a card skipped, with the timed path
broken underneath: each fault a cell can have, the benchmark's wrappers
catching nothing, and the check's control put in the program's place
must each turn ``correct`` false, and the unbroken run must stay true.
The cells run at a small size with their own limits."""

from __future__ import annotations

import copy
import time
import types

import numpy as np
import pytest
import torch

from h100bench import bench, run
from h100bench.drivers import _words
from h100bench.drivers import serve_scheduler as serve
from h100bench.traffic import words

CPU = torch.device("cpu")


def _small_sort_cell(name):
    cell = bench.load_cell(name)
    cell.traffic = dict(cell.traffic, words=2000, pool=2)
    if "chunk_size" in cell.traffic:
        cell.traffic["chunk_size"] = 700
    return cell


def _half(out):
    n = out[0].shape[0] // 2
    return (out[0][:n], out[1][:n],
            tuple(p[:n] for p in out[2]) if out[2] else out[2])


def _altered(out):
    keys = out[1].clone()
    keys[len(keys) // 2, 0] ^= 1
    return out[0], keys, out[2]


def _unchanged(keys, device, real):
    """The input handed back as it came, with its lengths."""
    lens = torch.from_numpy(words.byte_lengths(keys))
    out = real(keys, device)
    return lens, torch.from_numpy(keys.view(np.int32)).view(torch.uint32), \
        out[2]


SORT_FAULTS = {
    "none": lambda keys, dev, real: real(keys, dev),
    "state_unchanged": _unchanged,
    "half_left_out": lambda keys, dev, real: _half(real(keys, dev)),
    "answer_altered": lambda keys, dev, real: _altered(real(keys, dev)),
    "control": None,
}


def _broken_sort_driver(cell, fault):
    real = bench.load_driver(cell.spec["driver"])

    def setup(c, seed, device):
        state = real.setup(c, seed, device)
        if fault == "control":
            real.control(state)
            return state
        call = state["call"]
        state["call"] = lambda keys, dev: SORT_FAULTS[fault](keys, dev, call)
        return state

    return types.SimpleNamespace(setup=setup, window=_words.window,
                                 check=_words.check)


@pytest.mark.parametrize("name", ["ds2x8-oneshot", "ds2x16-chunked"])
@pytest.mark.parametrize("fault", list(SORT_FAULTS))
def test_sort_faults(name, fault):
    cell = _small_sort_cell(name)
    r = run.run_cell(cell, 2**31 + 17, 0.05, False, CPU, time.perf_counter(),
                     driver=_broken_sort_driver(cell, fault))
    assert r["correct"] is (fault == "none"), r["checks"]
    assert list(r["checks"])[-1] == "calls_failed"


def _small_serve_cell():
    cell = bench.load_cell("granite-long-prompt")
    cfg = copy.deepcopy(cell.config)
    cfg["model"].update(n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
                        head_dim=8, vocab_size=97, param_dtype="float32",
                        compute_dtype="float32")
    cfg["model"]["moe"].update(n_experts=4, top_k=2, d_expert=16)
    cfg["init"] = dict(cfg["init"], std=0.2)
    cfg["max_position_embeddings"] = 48
    cell.config = cfg
    cell.traffic = dict(cell.traffic, wave=12, prompt_median=16,
                        prompt_min=3, prompt_max=30, batch_size=4,
                        n_buckets=2, max_new=5)
    return cell


def _break_engine(state, fault):
    engine, sched = state["engine"], state["sched"]
    if fault == "state_unchanged":
        decode = engine._decode

        def stale(cache, tok, cur):
            """A decode step that hands back the cache it was given."""
            before = {k: {n: t.clone() for n, t in leaves.items()}
                      for k, leaves in cache.items()}
            logits, _ = decode(cache, tok, cur)
            return logits, before
        engine._decode = stale
    elif fault == "half_left_out":
        run_ = sched.run
        sched.run = lambda reqs: run_(reqs)[: len(reqs) // 2]
    elif fault == "token_altered":
        generate = engine.generate

        def altered(prompts, **kw):
            out = generate(prompts, **kw)
            v = state["cfg"].vocab_size
            out[0][-1] = (out[0][-1] + v // 2) % v
            return out
        engine.generate = altered
    elif fault == "batches_not_caught":
        # the wrappers go on a copy the scheduler never calls
        state["engine"] = copy.copy(engine)
    elif fault == "decode_not_caught":
        def bypass(prompts, max_new, greedy, seed):
            """The engine's loop with its own ``_decode``, not the one the
            benchmark put on the instance."""
            wrapped = engine.__dict__.pop("_decode")
            try:
                return type(engine)._generate(engine, prompts, max_new,
                                              greedy, seed)
            finally:
                engine._decode = wrapped
        engine._generate = bypass
    elif fault == "control":
        serve.control(state)


SERVE_FAULTS = ["none", "state_unchanged", "half_left_out", "token_altered",
                "batches_not_caught", "decode_not_caught", "control"]


@pytest.mark.parametrize("fault", SERVE_FAULTS)
def test_serve_faults(fault):
    cell = _small_serve_cell()

    def setup(c, seed, device):
        state = serve.setup(c, seed, device)
        _break_engine(state, fault)
        return state

    driver = types.SimpleNamespace(setup=setup, window=serve.window,
                                   check=serve.check)
    r = run.run_cell(cell, 2**31 + 23, 0.05, False, CPU, time.perf_counter(),
                     driver=driver)
    assert r["correct"] is (fault == "none"), (r["checks"], r["failed"])
    print(fault, r["checks"])
