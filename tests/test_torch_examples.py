"""The port's examples (``repro_torch.examples``) against the reference's
``examples/`` on the CPU, with the same inputs.

quickstart's sorted words, bucket count, (8, 256) rows and chunked output
equal the reference's (its ``sort_rows`` interpreted); Granite's smoke
forward from the reference's weights (``interop.lm_from_reference``)
within ``test_torch_models.py``'s tolerance; serve_lm's results and
padding stats equal the reference's engine's from the same weights;
train_lm at 60 steps with a failure at 55 recovers at the same step in
both packages. The two 8-rank examples run once in 8 gloo ranks
(``_torch_mesh.launch_ranks``), then the reference's
``examples/distributed_sort.py`` on 8 fake XLA devices and the port's
``moe_expert_parallel`` through its own 8-rank launcher: rank 0's lines
equal the reference script's, every output its numpy oracle, and
``ep_moe`` is within the reference's 2e-4 of the reference's ``moe``.
Without a card every example's default device raises.
"""

import dataclasses
import pickle
import re
import runpy
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_mesh import ROOT, _env, launch_ranks, run_reference
from repro.configs import get_smoke_config as ref_smoke_config
from repro.core import bucketed_sort_words as ref_bucketed_sort_words
from repro.core import pack_words as ref_pack_words
from repro.kernels import bucketize as ref_bucketize
from repro.kernels import sort_rows as ref_sort_rows
from repro.models import forward as ref_forward
from repro.models import init_lm as ref_init_lm
from repro.models.moe import init_moe as ref_init_moe
from repro.models.moe import moe as ref_moe
from repro.models.param import Builder as RefBuilder
from repro.models.param import finalize
from repro.parallel.sharding import Rules as RefRules
from repro.pipeline import chunked_sort_words as ref_chunked_sort_words
from repro.serve import BucketedScheduler as RefScheduler
from repro.serve import Engine as RefEngine
from repro.serve import Request as RefRequest
from repro_torch.configs import get_smoke_config
from repro_torch.data import synthetic_words
from repro_torch.examples import (distributed_sort, moe_expert_parallel,
                                  quickstart, serve_lm, train_lm)
from repro_torch.interop import lm_from_reference, to_numpy

TOL = dict(rtol=2e-4, atol=2e-4)         # test_torch_models.py's
EP_ATOL = moe_expert_parallel.EP_ATOL    # the reference's
EXAMPLES = ROOT / "examples"

_RANK_SCRIPT = r"""
import pickle
import numpy as np
from repro_torch.examples import distributed_sort, moe_expert_parallel
cpu = torch.device("cpu")
out = {"sort": distributed_sort.rank_demos(cpu)}
weights = dict(np.load(os.path.join(workdir, "moe.npz")))
out["moe"] = moe_expert_parallel.rank_demo(cpu, weights)
with open(os.path.join(workdir, f"out{rank}.pkl"), "wb") as f:
    pickle.dump(out, f)
"""


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _shortlex(words):
    return sorted(words, key=lambda w: (len(w), w))


def _ref_moe_case():
    """The reference example's weights and tokens (``Builder(PRNGKey(0))``,
    ``normal(PRNGKey(1))``) and its one-device ``moe`` output."""
    cfg = ref_smoke_config("granite-moe-1b-a400m")
    cfg = cfg.replace(moe=dataclasses.replace(
        cfg.moe, n_experts=8, top_k=2, capacity_factor=8.0, n_shared=0))
    params, _ = finalize(ref_init_moe(
        RefBuilder(jax.random.PRNGKey(0), dtype=jnp.float32), cfg))
    x = jax.random.normal(jax.random.PRNGKey(1),
                          (1, moe_expert_parallel.TOKENS, cfg.d_model))
    y, _ = ref_moe(cfg, params, x, RefRules())
    weights = {k: np.asarray(params[k]) for k in ("router", "w_in", "w_out")}
    weights["x"] = np.asarray(x)
    return weights, np.asarray(y)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The port's side on one intra-op thread: its examples run many small
    eager ops, and beside the suite's other workers torch's thread pool
    waits far longer than the ops take (the 60-step train_lm took over
    100 s in the whole suite's run on the default threads, seconds on
    one)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    """One 8-rank launch of both 8-rank examples from the reference's moe
    weights, then the reference's distributed_sort script and the port's
    moe_expert_parallel through its own launcher, one after another (the
    module's last tests use it, so no other test of the module runs beside
    these processes)."""
    workdir = tmp_path_factory.mktemp("ranks")
    weights, y_ref = _ref_moe_case()
    np.savez(workdir / "moe.npz", **weights)
    launch_ranks(_RANK_SCRIPT, 8, workdir, timeout=240)
    outs = []
    for r in range(8):
        with open(workdir / f"out{r}.pkl", "rb") as f:
            outs.append(pickle.load(f))
    ref_lines = run_reference(
        (EXAMPLES / "distributed_sort.py").read_text()).splitlines()
    moe_main = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.moe_expert_parallel",
         "--device", "cpu"], capture_output=True, text=True, env=_env(),
        timeout=240)
    return dict(y_ref=y_ref, outs=outs, ref_lines=ref_lines,
                moe_main=moe_main,
                rank0_lines=(workdir / "rank0.log").read_text().splitlines())


# ---------------- quickstart ----------------

def test_quickstart_paper_pipeline_equals_reference():
    words = synthetic_words(2_000, seed=0)
    got, n_buckets = quickstart.demo_paper_pipeline("cpu")
    assert got == ref_bucketed_sort_words(words, algorithm="oets")
    assert n_buckets == int((ref_bucketize(jnp.asarray(
        ref_pack_words(words)))[1] > 0).sum())


def test_quickstart_rows_bit_equal_interpreted_reference():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 10**6, (8, 256)).astype(np.int32)
    got = to_numpy(quickstart.demo_row_kernel("cpu"))
    want = np.asarray(ref_sort_rows(jnp.asarray(x), algorithm="oets",
                                    interpret=True))
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


def test_quickstart_chunked_equals_reference():
    words = synthetic_words(600, seed=2)
    got = quickstart.demo_chunked_pipeline("cpu")
    assert got == ref_chunked_sort_words(words, chunk_size=128) == \
        _shortlex(words)


def test_quickstart_moe_forward_matches_reference():
    cfg = ref_smoke_config(quickstart.MOE_ARCH)
    params, _ = ref_init_lm(cfg, jax.random.PRNGKey(0))
    tokens = jax.random.randint(jax.random.PRNGKey(1), (2, 16), 0,
                                cfg.vocab_size)
    want, want_aux, _ = ref_forward(cfg, params, {"tokens": tokens},
                                    RefRules())
    lm = lm_from_reference(get_smoke_config(quickstart.MOE_ARCH), _np(params),
                           device="cpu")
    logits, aux = quickstart.demo_moe_lm("cpu", lm=lm,
                                         tokens=np.asarray(tokens))
    np.testing.assert_allclose(to_numpy(logits), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), **TOL)


# ---------------- serve_lm ----------------

def test_serve_lm_equals_reference():
    cfg = ref_smoke_config(serve_lm.ARCH)
    params, _ = ref_init_lm(cfg, jax.random.PRNGKey(0))
    results, stats = serve_lm.serve("cpu", lm=lm_from_reference(
        get_smoke_config(serve_lm.ARCH), _np(params), device="cpu"))
    reqs = [RefRequest(r.request_id, r.prompt, r.max_new)
            for r in serve_lm.requests(cfg.vocab_size)]
    engine = RefEngine(cfg, params, RefRules(), max_seq=96)
    want = RefScheduler(engine, batch_size=8,
                        bounds=serve_lm.BOUNDS).run(reqs)
    assert [(r.request_id, r.tokens) for r in results] == \
        [(r.request_id, r.tokens) for r in want]
    assert len(results) == 24 and all(len(r.tokens) == 8 for r in results)
    assert stats == RefScheduler.padding_stats(reqs, bounds=serve_lm.BOUNDS)


# ---------------- train_lm ----------------

def test_train_lm_recovers_as_the_reference(capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["train_lm.py", "--steps", "60",
                                      "--fail-at", "55"])
    runpy.run_path(str(EXAMPLES / "train_lm.py"), run_name="__main__")
    ref_out = capsys.readouterr().out
    losses, events = train_lm.train("glm4-9b", steps=60, fail_at=55,
                                     device="cpu")
    out = capsys.readouterr().out

    def recovered(text):
        return re.findall(r"^recovered at step .*$", text, re.M)

    assert recovered(out) == recovered(ref_out) == \
        ["recovered at step 50: 1 -> 1 devices"]
    assert [e.step for e in events] == [50]
    n_ref = int(re.search(r"over (\d+) steps", ref_out).group(1))
    assert len(losses) == n_ref == 55 + 10
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


# ---------------- the 8-rank examples ----------------

def test_distributed_sort_lines_equal_reference_script(mesh):
    ref_lines = mesh["ref_lines"]
    assert ref_lines[-1] == "distributed_sort complete"
    n = len(ref_lines) - 1
    assert mesh["rank0_lines"][:n] == ref_lines[:-1]
    # then the moe_expert_parallel demo's two lines, run by the same ranks
    assert mesh["rank0_lines"][n].startswith("8-way expert-parallel")
    assert len(mesh["rank0_lines"]) == n + 2


def test_distributed_sort_outputs_equal_numpy_oracles(mesh):
    outs = [o["sort"] for o in mesh["outs"]]
    rng = np.random.default_rng(0)
    for n in (8 * 4096, 10_001):
        want = np.sort(rng.integers(0, 10**9, n).astype(np.int32))
        for key in (*(f"odd_even-{m}-{n}" for m in ("resort", "bitonic",
                                                     "take")),
                    f"sample-{n}"):
            for o in outs:
                np.testing.assert_array_equal(o["engines"][key], want)
    rng = np.random.default_rng(7)
    alphabet = np.array(list("abcdefghij"))
    words = ["".join(rng.choice(alphabet, rng.integers(1, 8)))
             for _ in range(1003)]
    rng = np.random.default_rng(3)
    k = rng.integers(0, 50, 999).astype(np.int32)
    kv = sorted(zip(k.tolist(), range(999)))
    for o in outs:
        assert o["words"] == _shortlex(words)
        assert list(zip(o["kv"][0].tolist(), o["kv"][1].tolist())) == kv
    full = np.random.default_rng(1).integers(0, 1 << 63, 250,
                                             dtype=np.uint64)
    np.testing.assert_array_equal(outs[0]["lex"], np.sort(full))
    assert all("lex" not in o for o in outs[1:])


def test_ep_moe_within_reference_bound_of_reference_moe(mesh):
    y_ref = mesh["y_ref"]
    for o in mesh["outs"]:
        np.testing.assert_allclose(o["moe"]["y_ep"], y_ref, rtol=0,
                                   atol=EP_ATOL)
        np.testing.assert_allclose(o["moe"]["y_moe"], y_ref, rtol=0,
                                   atol=EP_ATOL)
        assert o["moe"]["err"] < EP_ATOL


def test_moe_expert_parallel_main_launches_its_own_ranks(mesh):
    res = mesh["moe_main"]
    assert res.returncode == 0, res.stderr[-4000:]
    lines = res.stdout.splitlines()
    assert lines[0].startswith("8-way expert-parallel dispatch")
    err = float(re.fullmatch(r"max \|EP - moe\| = (\S+)", lines[1]).group(1))
    assert err < EP_ATOL
    assert lines[-1] == "moe_expert_parallel complete"


# ---------------- the device ----------------

@pytest.mark.parametrize("module", [quickstart, serve_lm, train_lm,
                                   distributed_sort, moe_expert_parallel],
                         ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_main_defaults_to_the_card(module):
    """Here, where there is no card, ``main`` with the default device
    raises before it computes anything; on a card it is the examples' own
    run (``chip_smoke.py`` phase 11)."""
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main([])
