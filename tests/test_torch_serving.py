"""The port's serving path (``repro_torch.serve``, ``launch.serve``)
against the reference's on the CPU, from the same weights: greedy
``Engine.generate`` tokens (GQA, MoE, MLA and the Zamba2 hybrid) on
mixed-length batches and with an eos, ``BucketedScheduler`` admission
permutations at queue sizes on every kernel tier, ``run`` results and
``padding_stats``, admission over a one-rank mesh, and the serving CLI."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from _torch_mesh import launch_ranks
from repro.configs import get_smoke_config
from repro.models import init_lm as ref_init_lm
from repro.parallel.sharding import Rules as RefRules
from repro.serve import BucketedScheduler as RefScheduler
from repro.serve import Engine as RefEngine
from repro.serve import Request as RefRequest
from repro_torch.interop import lm_from_reference
from repro_torch.serve import BucketedScheduler, Engine, Request

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", params=["glm4-9b", "granite-moe-1b-a400m",
                                        "minicpm3-4b", "zamba2-1.2b"])
def engines(request):
    """(cfg, the reference's engine, the port's) from the same weights."""
    cfg = get_smoke_config(request.param)
    params, _ = ref_init_lm(cfg, jax.random.PRNGKey(0))
    lm = lm_from_reference(cfg, jax.tree.map(np.asarray, params),
                           device="cpu")
    return (cfg, RefEngine(cfg, params, RefRules(), max_seq=64),
            Engine(cfg, lm, max_seq=64))


def test_greedy_generate_equals_reference(engines):
    """Mixed lengths in one batch: per-row cache writes and masks, the
    padding routed through the MoE like real tokens (capacity at its
    default, so one row's padding can crowd another row's tokens out)."""
    cfg, ref, port = engines
    rng = np.random.default_rng(0)
    prompts = [list(rng.integers(1, cfg.vocab_size, n))
               for n in (3, 7, 12, 5)]
    assert port.generate(prompts, max_new=6) == ref.generate(prompts,
                                                             max_new=6)
    alone = [list(rng.integers(1, cfg.vocab_size, 9))]
    assert port.generate(alone, max_new=4) == ref.generate(alone, max_new=4)


def test_eos_stops_each_request(engines):
    cfg, ref, port = engines
    rng = np.random.default_rng(2)
    prompts = [list(rng.integers(1, cfg.vocab_size, n)) for n in (4, 6)]
    free = port.generate(prompts, max_new=5)
    eos = free[0][1]
    ref.eos_id = port.eos_id = eos
    try:
        stopped = port.generate(prompts, max_new=5)
        assert stopped == ref.generate(prompts, max_new=5)
    finally:
        ref.eos_id = port.eos_id = None
    assert stopped[0] == free[0][:free[0].index(eos) + 1]


def test_sampling_is_seeded(engines):
    cfg, _, port = engines
    prompts = [[1, 2, 3], [4, 5]]
    a = port.generate(prompts, max_new=4, greedy=False, seed=7)
    assert a == port.generate(prompts, max_new=4, greedy=False, seed=7)
    assert all(len(r) == 4 for r in a)


def _queue(n, seed):
    """Requests with short prompts from a small alphabet, so lengths and
    the first two tokens tie often, and empty and one-token prompts."""
    rng = np.random.default_rng(seed)
    return [(i, [int(t) for t in rng.integers(0, 4, rng.integers(0, 6))])
            for i in range(n)]


@pytest.mark.parametrize("n", [1, 2, 127, 128, 129, 1100])
def test_admission_order_equals_reference(n):
    q = _queue(n, seed=n)
    want = RefScheduler._order_by_length([RefRequest(i, p) for i, p in q])
    got = BucketedScheduler._order_by_length([Request(i, p) for i, p in q],
                                             device="cpu")
    assert [r.request_id for r in got] == [r.request_id for r in want]


def test_run_and_padding_stats_equal_reference(engines):
    cfg, ref, port = engines
    rng = np.random.default_rng(3)
    q = [(i, list(rng.integers(1, cfg.vocab_size, rng.integers(2, 30))),
          int(rng.integers(1, 4))) for i in range(10)]
    bounds = [8, 16, 32]
    want = RefScheduler(ref, batch_size=4, bounds=bounds).run(
        [RefRequest(*r) for r in q])
    got = BucketedScheduler(port, batch_size=4, bounds=bounds).run(
        [Request(*r) for r in q])
    assert [(r.request_id, r.tokens) for r in got] == \
        [(r.request_id, r.tokens) for r in want]
    reqs = [Request(*r) for r in q] + [Request(99, list(range(50)))]
    for b in (bounds, [4, 40]):
        assert BucketedScheduler.padding_stats(reqs, b) == \
            RefScheduler.padding_stats([RefRequest(r.request_id, r.prompt)
                                        for r in reqs], b)


def test_run_plans_bounds_from_the_wave(engines):
    cfg, ref, port = engines
    rng = np.random.default_rng(4)
    q = [(i, list(rng.integers(1, cfg.vocab_size, rng.integers(2, 20))), 2)
         for i in range(9)]
    want = RefScheduler(ref, batch_size=3).run([RefRequest(*r) for r in q])
    got = BucketedScheduler(port, batch_size=3).run([Request(*r) for r in q])
    assert [(r.request_id, r.tokens) for r in got] == \
        [(r.request_id, r.tokens) for r in want]


_MESH_RANK = r"""
import json
import numpy as np
from repro_torch.parallel import make_mesh
from repro_torch.serve import BucketedScheduler, Request
mesh = make_mesh((world,), ("data",), "cpu")
out = {}
for n in (2, 129, 700):
    rng = np.random.default_rng(n)
    rs = [Request(i, [int(t) for t in rng.integers(0, 4, rng.integers(0, 6))])
          for i in range(n)]
    on_mesh = BucketedScheduler._order_by_length(rs, mesh=mesh, axis="data",
                                                 device="cpu")
    alone = BucketedScheduler._order_by_length(rs, device="cpu")
    out[n] = [[r.request_id for r in on_mesh], [r.request_id for r in alone]]
json.dump(out, open(os.path.join(workdir, "order.json"), "w"))
"""


def test_mesh_admission_at_world_size_one_equals_single_device(tmp_path):
    import json
    launch_ranks(_MESH_RANK, 1, tmp_path, timeout=120)
    out = json.loads((tmp_path / "order.json").read_text())
    assert sorted(out) == ["129", "2", "700"]
    for on_mesh, alone in out.values():
        assert on_mesh == alone


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "minicpm3-4b",
                                  "zamba2-1.2b"])
def test_serve_cli_runs_on_the_cpu(arch):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         arch, "--smoke", "--device", "cpu", "--requests",
         "10", "--max-new", "3", "--sort-impl", "pallas"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "10 requests, 30 tokens" in res.stdout
    assert "padding waste" in res.stdout


def test_engine_defaults_follow_the_model_to_the_card():
    """Without a card the defaults raise; the engine runs where its
    model is."""
    from repro_torch.launch import serve
    from repro_torch.models import init_lm
    cfg = get_smoke_config("glm4-9b")
    if torch.cuda.is_available():
        assert Engine(cfg, init_lm(cfg)).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_lm(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "glm4-9b", "--smoke"])
    assert Engine(cfg, init_lm(cfg, device="cpu")).device.type == "cpu"
