"""The yardstick on the CPU: the generators' determinism, the references
on hand cases and against the port at a tiny size, and the trace and
metric arithmetic on a synthetic trace."""

from __future__ import annotations

import copy

import numpy as np
import pytest
import torch

from h100bench import bench, peaks
from h100bench.reference import granite_moe, shortlex
from h100bench.trace import function_name, merge_intervals, reduce_events
from h100bench.traffic import prompts, weights, words


# ---------------- traffic ----------------

def test_corpus_is_a_function_of_the_seed():
    a = words.corpus(2000, 2**31 + 5, 0)
    b = words.corpus(2000, 2**31 + 5, 0)
    c = words.corpus(2000, 2**31 + 5, 1)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], c[0])
    # every corpus of a size holds the same multiset of lengths
    assert np.array_equal(np.bincount(a[1]), np.bincount(c[1]))
    assert np.array_equal(np.bincount(a[1], minlength=16)[1:],
                          words.length_counts(2000))
    # the lengths are the packed words' byte lengths, letters a-z
    assert np.array_equal(words.byte_lengths(a[0]), a[1])
    b0 = (a[0][:, 0] >> 24) & 0xFF
    assert b0.min() >= ord("a") and b0.max() <= ord("z")


def test_corpus_packs_as_the_port_does():
    from repro_torch.core.packing import pack_words, unpack_words
    keys, lens = words.corpus(300, 3, 0)
    assert np.array_equal(pack_words(unpack_words(keys), width=16), keys)
    assert [len(w) for w in unpack_words(keys)] == lens.tolist()


def test_length_counts_and_letters():
    counts = words.length_counts(1_840_000)
    assert counts.sum() == 1_840_000 and counts.argmax() == 2
    table = words.letter_table()
    assert len(table) == 65536 and np.all(np.diff(table.astype(int)) >= 0)
    p = np.bincount(table) / len(table)
    assert abs(p[0] / p[1] - 2.0) < 0.01


def test_prompt_waves():
    mix = bench.load_cell("granite-long-prompt").traffic
    ls = prompts.lengths(mix)
    assert len(ls) == mix["wave"] and ls.min() >= mix["prompt_min"]
    assert ls.max() == mix["prompt_max"]
    assert abs(np.median(ls) - mix["prompt_median"]) < 20
    w0 = prompts.wave(mix, 7, 0, 1000)
    assert w0 == prompts.wave(mix, 7, 0, 1000)
    assert w0 != prompts.wave(mix, 7, 1, 1000)
    assert sorted(len(p) for _, p in w0) == sorted(ls.tolist())
    assert all(0 <= t < 1000 for _, p in w0 for t in p)


def _tiny(config):
    cfg = copy.deepcopy(config)
    cfg["model"].update(n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
                        head_dim=8, vocab_size=64, param_dtype="float32",
                        compute_dtype="float32")
    cfg["model"]["moe"].update(n_experts=4, top_k=2, d_expert=16)
    return cfg


def test_weights_fit_the_port_and_repeat():
    from h100bench.drivers.serve_scheduler import build_lm
    cfg = _tiny(bench.load_cell("granite-long-prompt").config)
    a = weights.draw(cfg, 11, "cpu")
    b = weights.draw(cfg, 11, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    _, lm = build_lm(cfg, 11, "cpu")          # strict: every name and shape
    assert torch.equal(lm.blocks[1].moe.w_in, a["blocks.1.moe.w_in"])
    assert float(a["head"].std()) == pytest.approx(0.02, rel=0.2)


# ---------------- references ----------------

def test_shortlex_on_hand_words():
    from repro_torch.core.packing import pack_words
    ws = ["b", "ab", "a", "zz", "aa", "abc", "z"]
    keys = pack_words(ws, width=16)
    lens = np.array([len(w) for w in ws], np.int32)
    sl, sk = shortlex.sort(lens, keys)
    assert sl.tolist() == [1, 1, 1, 2, 2, 2, 3]
    assert np.array_equal(sk, pack_words(["a", "b", "z", "aa", "ab", "zz",
                                          "abc"], width=16))
    assert shortlex.rows_off(sl, sk, sl, sk) == 0
    assert shortlex.rows_off(sl, sk, sl[:-2], sk[:-2]) == 2
    assert shortlex.rows_off(sl, sk, sl[::-1], sk[::-1]) == 6


def test_packed_keys_match_the_port():
    from repro_torch.kernels.keypack import pack_shortlex
    keys, lens = words.corpus(5000, 9, 0)
    sl, sk = shortlex.sort(lens, keys)
    want = shortlex.pack(sl, sk)
    got = pack_shortlex(torch.from_numpy(sl),
                        torch.from_numpy(sk.view(np.int32)).view(torch.uint32))
    got = tuple(g.view(torch.int32).numpy().view(np.uint32) for g in got.lanes)
    assert shortlex.packed_off(want, got) == 0
    assert shortlex.packed_off(want, got[:1]) == len(sl)


def test_the_control_sort_breaks_exact_order():
    from repro_torch.core.packing import pack_words
    # equal to float32 in lane 0: they differ only in the fourth byte
    ws = ["abcz", "abca"]
    keys = pack_words(ws, width=16)
    lens = np.array([4, 4], np.int32)
    want = shortlex.sort(lens, keys)
    assert shortlex.rows_off(*want, *shortlex.control_sort(lens, keys)) == 2
    keys, lens = words.corpus(20000, 4, 0)
    want = shortlex.sort(lens, keys)
    assert shortlex.rows_off(*want, *shortlex.control_sort(lens, keys)) > 0


def test_granite_reference_follows_the_port_in_float32():
    """The plain reference against the port's engine at a tiny size, in
    float32: prefill and decode of one batch with padding and drops."""
    from h100bench.drivers.serve_scheduler import build_lm
    from repro_torch.models.model import decode_step, forward
    from repro_torch.parallel.sharding import Rules
    cfg = _tiny(bench.load_cell("granite-long-prompt").config)
    cfg["model"]["moe"]["capacity_factor"] = 0.5      # force drops
    mcfg, lm = build_lm(cfg, 3, "cpu")
    ref = granite_moe.Plain(cfg["model"], weights.draw(cfg, 3, "cpu"))
    lens = torch.tensor([7, 3, 5])
    toks = torch.randint(0, 64, (3, 7), generator=torch.Generator().manual_seed(0))
    mask = (torch.arange(7)[None] < lens[:, None]).to(torch.int32)
    toks = toks * mask
    with torch.no_grad():
        logits, _, cache = forward(mcfg, lm, {"tokens": toks, "seq_mask": mask},
                                   Rules(), sort_impl="xla", return_cache=True)
        want = logits[torch.arange(3), lens - 1]
        got, rcache = ref.prefill(toks, lens)
        assert torch.allclose(got, want, atol=1e-5)
        from repro_torch.models.model import init_cache
        from repro_torch.serve.engine import _pad_cache_to
        axes = init_cache(mcfg, 3, 7, abstract=True)[1]
        cache = _pad_cache_to(cache, axes, 16)
        tok = torch.tensor([5, 9, 1])
        l2, _ = decode_step(mcfg, lm, cache, tok[:, None], lens.to(torch.int32),
                            Rules(), sort_impl="xla")
        r2 = ref.decode(rcache, tok, lens)
        assert torch.allclose(r2, l2[:, 0], atol=1e-5)
    # the control reads otherwise
    ctl = granite_moe.Plain(cfg["model"], weights.draw(cfg, 3, "cpu"),
                            precision="fp8")
    c1, _ = ctl.prefill(toks, lens)
    assert (c1 - got).abs().max() > 1e-3


def test_capacity_rule():
    assert granite_moe.capacity(1.25, 32, 8, 32) == 16
    assert granite_moe.capacity(1.25, 1, 8, 32) == 8
    assert granite_moe.capacity(1.25, 65024, 8, 32) == 20320


# ---------------- trace and metrics ----------------

def test_function_names():
    assert function_name("void bitonic_window_kernel<4, 2>(unsigned int*, int)") \
        == "bitonic_window_kernel"
    assert function_name("void at::native::vectorized_elementwise_kernel<4, "
                         "at::native::FillFunctor<float> >(int, float)") \
        == "vectorized_elementwise_kernel"
    assert function_name("oets_rows_kernel") == "oets_rows_kernel"
    assert function_name("Memcpy HtoD (Pageable -> Device)") == \
        "Memcpy HtoD (Pageable -> Device)"


def test_busy_time_gaps_and_labels():
    ev = [("void merge_regs_kernel<4>(int)", 100, 300),
          ("void merge_regs_kernel<4>(int)", 250, 400),
          ("oets_warp_kernel", 600, 700),
          ("Memset (Device)", 950, 1000),
          ("outside", 2000, 3000)]
    spans = [("sort call", 0, 500), ("decode", 500, 1000)]
    r = reduce_events(ev, 0, 1000, spans)
    assert merge_intervals([(1, 3), (2, 4), (6, 7)]) == [[1, 4], [6, 7]]
    assert r["busy_s"] == pytest.approx(450e-9)
    assert r["window_s"] == pytest.approx(1000e-9)
    assert r["ops"]["merge_regs_kernel"] == (pytest.approx(350e-9), 2)
    assert r["gaps"][0] == ("decode", pytest.approx(250e-9))
    assert sorted(g for _, g in r["gaps"]) == pytest.approx(
        [100e-9, 200e-9, 250e-9])
    assert {lab for lab, _ in r["gaps"]} == {"sort call", "decode"}


def _records():
    tr = reduce_events([("void bitonic_regs_kernel<4>(int)", 0, 2_000_000),
                        ("kway_kernel", 2_000_000, 3_000_000),
                        ("void merge_window_kernel<1, 2>(int)", 3_000_000,
                         5_000_000)], 0, 10_000_000,
                       [("prefill", 0, 10_000_000)])
    tr["counts"] = {"calls": 2, "prefills": 4}
    return {"trace": tr, "calls": 100, "window_s": 2.0,
            "least_bytes_per_call": 3.35e9, "launches": {"a": 300, "b": 100},
            "model_flops": 989e12,
            "spans": [("prefill", 0, 2_000_000), ("prefill", 0, 4_000_000),
                      ("decode", 0, 1_000_000)]}


@pytest.mark.parametrize("name,want", [
    ("bucket_sort_ms", 2.0), ("combine_ms", 0.5), ("sort_roofline", 5.0),
    ("launches.words", 4.0), ("device_idle.words", 50.0),
    ("device_idle.serve", 50.0), ("dispatch_sort_ms", 1.0),
    ("prefill_ms", 3.0), ("decode_ms", 1.0), ("mfu.serve", 50.0)])
def test_metric_readers(name, want):
    assert bench.load_metric(name)(_records()) == pytest.approx(want)


@pytest.mark.parametrize("name", [
    "bucket_sort_ms", "combine_ms", "device_idle.words", "dispatch_sort_ms",
    "prefill_ms", "mfu.serve"])
def test_readers_without_a_trace_return_nothing(name):
    rec = {"trace": None, "calls": 0, "window_s": 0.0, "launches": {},
           "spans": [], "least_bytes_per_call": 1}
    assert bench.load_metric(name)(rec) is None


def test_percentile_and_peaks():
    assert bench.percentile(list(range(101)), 95) == 95
    assert bench.percentile([1.0, 2.0], 50) == 1.5
    assert peaks.BF16_FLOPS == 989e12 and peaks.HBM_BYTES_PER_S == 3.35e12
