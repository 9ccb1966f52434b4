"""The port's model stack (``repro_torch.models``) against the reference's
on the CPU, at the smoke configs, from the same weights
(``interop.lm_from_reference``): forward logits and aux, ``lm_loss``,
decode step by step, a prefill's cache then per-row decode — for all ten
archs (GQA, MLA, MoE, the Mamba2 SSM, the Zamba2 hybrid) — the MoE layer
with every dispatch sort at the default capacity (with drops, permutations
exactly equal) and chunked attention."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import forward as ref_forward
from repro.models import init_cache as ref_init_cache
from repro.models import init_lm as ref_init_lm
from repro.models import lm_loss as ref_lm_loss
from repro.models import moe as ref_moe_mod
from repro.models.param import Builder as RefBuilder
from repro.models.param import finalize
from repro.parallel.sharding import Rules as RefRules
from repro_torch.configs import ARCH_IDS, SHAPES, cells_for, get_config, \
    get_smoke_config
from repro_torch.interop import lm_from_reference
from repro_torch.models import (decode_step, forward, init_cache, init_lm,
                                lm_loss, moe as moe_mod)
from repro_torch.models.param import Builder
from repro_torch.parallel.sharding import Rules

PORTED = ["granite-moe-1b-a400m", "glm4-9b", "llama3-405b",
          "nemotron-4-340b", "qwen2-vl-2b", "musicgen-large",
          "deepseek-v2-236b", "minicpm3-4b", "mamba2-370m", "zamba2-1.2b"]
RULES, REF_RULES = Rules(), RefRules()
B, S = 2, 16
TOL = dict(rtol=2e-4, atol=2e-4)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(cfg, seed=0, b=B, s=S):
    rng = np.random.default_rng(seed)
    out = {"labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    out["labels"][:, -2:] = -1                 # masked positions
    if cfg.input_kind == "tokens":
        out["tokens"] = rng.integers(0, cfg.vocab_size, (b, s)).astype(
            np.int32)
    else:
        out["frames"] = rng.normal(size=(b, s, cfg.d_model)).astype(
            np.float32)
    return out


def _inputs(batch):
    return {k: v for k, v in batch.items() if k != "labels"}


@pytest.fixture(scope="module", params=PORTED)
def arch(request):
    """(arch, cfg, reference params, port LM) — built once a module."""
    cfg = ref_smoke_config(request.param)
    params, _ = ref_init_lm(cfg, jax.random.PRNGKey(0))
    lm = lm_from_reference(cfg, _np_tree(params), device="cpu")
    return request.param, cfg, params, lm


def test_configs_copy_the_reference():
    from repro import configs as ref_configs
    assert ARCH_IDS == ref_configs.ARCH_IDS
    for a in ARCH_IDS:
        assert dataclasses.asdict(get_config(a)) == \
            dataclasses.asdict(ref_configs.get_config(a))
        assert dataclasses.asdict(get_smoke_config(a)) == \
            dataclasses.asdict(ref_configs.get_smoke_config(a))
        assert [c.name for c in cells_for(get_config(a))] == \
            [c.name for c in ref_configs.cells_for(get_config(a))]
    assert SHAPES.keys() == ref_configs.SHAPES.keys()


def test_forward_loss_and_aux_match_reference(arch):
    name, cfg, params, lm = arch
    batch = _batch(cfg)
    want, want_aux, _ = jax.jit(
        lambda p, b: ref_forward(cfg, p, b, REF_RULES))(
        params, {k: jnp.asarray(v) for k, v in _inputs(batch).items()})
    with torch.no_grad():
        got, got_aux, _ = forward(cfg, lm, _inputs(batch), RULES)
        loss, metrics = lm_loss(cfg, lm, batch, RULES)
    assert got.shape == (B, S, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(got_aux), float(want_aux), **TOL)
    rl, rm = jax.jit(lambda p, b: ref_lm_loss(cfg, p, b, REF_RULES))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), float(rl), **TOL)
    np.testing.assert_allclose(float(metrics["ce"]), float(rm["ce"]), **TOL)


def test_decode_matches_forward(arch):
    """Step-by-step decode == the teacher-forced forward; the MoE capacity
    is raised so no assignment drops (the reference's test)."""
    name, cfg, params, _ = arch
    if cfg.moe:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                  capacity_factor=8.0))
    lm = lm_from_reference(cfg, _np_tree(params), device="cpu")
    batch = _inputs(_batch(cfg, seed=1))
    inp = batch.get("tokens", batch.get("frames"))
    with torch.no_grad():
        want, _, _ = forward(cfg, lm, batch, RULES)
        cache, axes = init_cache(cfg, B, S, device="cpu")
        assert axes == ref_init_cache(cfg, B, S, abstract=True)[1]
        outs = []
        for t in range(S):
            lg, cache = decode_step(cfg, lm, cache, inp[:, t:t + 1],
                                    torch.tensor(t), RULES)
            outs.append(lg[:, 0])
    err = float((torch.stack(outs, 1) - want).abs().max())
    assert err < 2e-3, err


def test_prefill_cache_then_per_row_decode(arch):
    """A prefill's cache grown to a capacity, then decode with a per-row
    position, equals the forward over the longer sequence."""
    name, cfg, params, _ = arch
    if cfg.moe:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                  capacity_factor=8.0))
    lm = lm_from_reference(cfg, _np_tree(params), device="cpu")
    batch = _inputs(_batch(cfg, seed=2, s=9))
    key = "tokens" if "tokens" in batch else "frames"
    with torch.no_grad():
        full, _, _ = forward(cfg, lm, batch, RULES)
        head = {key: batch[key][:, :8]}
        _, _, cache = forward(cfg, lm, head, RULES, return_cache=True)
        grown, axes = init_cache(cfg, B, 12, device="cpu")
        for name_, leaves in cache.items():
            for k, leaf in leaves.items():
                if "cache_seq" in axes[name_][k]:
                    grown[name_][k][:, :, :8] = leaf
                else:                  # Mamba2's window and state
                    grown[name_][k].copy_(leaf)
        lg, _ = decode_step(cfg, lm, grown, batch[key][:, 8:9],
                            torch.tensor([8, 8]), RULES)
    assert float((lg[:, 0] - full[:, 8]).abs().max()) < 2e-3


@pytest.mark.parametrize("sort_impl", ["oets", "bitonic", "pallas"])
def test_granite_forward_with_each_dispatch_sort(sort_impl):
    cfg = ref_smoke_config("granite-moe-1b-a400m")
    params, _ = ref_init_lm(cfg, jax.random.PRNGKey(0))
    lm = lm_from_reference(cfg, _np_tree(params), device="cpu")
    batch = _inputs(_batch(cfg, seed=3))
    want, want_aux, _ = ref_forward(
        cfg, params, {"tokens": jnp.asarray(batch["tokens"])}, REF_RULES,
        sort_impl=sort_impl)
    with torch.no_grad():
        got, got_aux, _ = forward(cfg, lm, batch, RULES, sort_impl=sort_impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(got_aux), float(want_aux), **TOL)


# ---------------- the MoE layer ----------------

@pytest.fixture(scope="module")
def moe_layer():
    cfg = ref_smoke_config("granite-moe-1b-a400m")
    p, _ = finalize(ref_moe_mod.init_moe(RefBuilder(jax.random.PRNGKey(0)),
                                         cfg))
    port = moe_mod.MoE(Builder(None, device="meta"), cfg)
    port.load_state_dict({k: torch.from_numpy(np.asarray(v).copy())
                          for k, v in p.items()}, assign=True)
    # a shared direction in every token skews the routing: at the default
    # capacity some expert gets more assignments than it can keep
    rng = np.random.default_rng(5)
    x = (rng.normal(size=(2, 16, cfg.d_model))
         + 2.0 * rng.normal(size=(1, 1, cfg.d_model))).astype(np.float32)
    return cfg, p, port, x


def _recording(monkeypatch, module):
    seen = []
    real = module._sort_assignments

    def rec(flat_e, payload, impl):
        out = real(flat_e, payload, impl)
        seen.append((np.asarray(out[0]).copy(), np.asarray(out[1]).copy()))
        return out

    monkeypatch.setattr(module, "_sort_assignments", rec)
    return seen


@pytest.mark.parametrize("sort_impl", ["xla", "oets", "bitonic", "pallas"])
@pytest.mark.parametrize("impl", ["sort", "einsum"])
def test_moe_dispatch_with_drops_matches_reference(moe_layer, monkeypatch,
                                                   impl, sort_impl):
    cfg, p, port, x = moe_layer
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, impl=impl))
    ref_seen = _recording(monkeypatch, ref_moe_mod)
    port_seen = _recording(monkeypatch, moe_mod)
    want, want_aux = ref_moe_mod.moe(cfg, p, jnp.asarray(x), REF_RULES,
                                     sort_impl=sort_impl)
    with torch.no_grad():
        got, got_aux = moe_mod.moe(cfg, port, torch.from_numpy(x), RULES,
                                   sort_impl=sort_impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(got_aux), float(want_aux), **TOL)
    # at least one assignment dropped at the default capacity
    t = x.shape[0] * x.shape[1]
    _, top_e = moe_mod._top_k(torch.softmax(
        torch.from_numpy(x.reshape(t, -1)) @ port.router, -1), cfg.moe.top_k)
    counts = torch.bincount(top_e.reshape(-1), minlength=cfg.moe.n_experts)
    assert int(counts.max()) > moe_mod.capacity(cfg, t)
    assert len(ref_seen) == len(port_seen) == (impl == "sort")
    for (rk, rp), (pk, pp) in zip(ref_seen, port_seen):
        np.testing.assert_array_equal(pk.astype(np.int64), rk)
        np.testing.assert_array_equal(pp.astype(np.int64), rp)


def test_top_k_puts_the_lower_expert_first_on_ties():
    probs = torch.tensor([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.1, 0.4]])
    vals, idx = moe_mod._top_k(probs, 2)
    rv, ri = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(rv))


# ---------------- attention ----------------

@pytest.mark.parametrize("name", ["glm4-9b", "nemotron-4-340b"])
def test_chunked_attention_matches_full(name):
    cfg = ref_smoke_config(name)
    params, _ = ref_init_lm(cfg, jax.random.PRNGKey(0))
    lm = lm_from_reference(cfg, _np_tree(params), device="cpu")
    tokens = np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 32))
    chunked = cfg.replace(attn_kv_chunk=8)
    with torch.no_grad():
        full, _, _ = forward(cfg, lm, {"tokens": tokens}, RULES)
        got, _, _ = forward(chunked, lm, {"tokens": tokens}, RULES)
    assert float((got - full).abs().max()) < 1e-4
    want, _, _ = ref_forward(chunked, params,
                             {"tokens": jnp.asarray(tokens)}, REF_RULES)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ---------------- init ----------------

def test_init_lm_draws_from_its_generator():
    cfg = get_smoke_config("granite-moe-1b-a400m")
    a = init_lm(cfg, seed=3, device="cpu")
    b = init_lm(cfg, seed=3, device="cpu")
    c = init_lm(cfg, seed=4, device="cpu")
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["blocks.0.moe.w_in"], sc["blocks.0.moe.w_in"])
    assert torch.equal(sa["blocks.1.ln1.w"], torch.ones(cfg.d_model))
    meta = init_lm(cfg, device="meta")
    assert meta.embed.device.type == "meta"


def test_builder_init_kinds():
    g = torch.Generator().manual_seed(0)
    b = Builder(g, dtype=torch.bfloat16)
    w = b.param((256, 64))
    assert w.dtype == torch.bfloat16 and w.requires_grad    # trainable
    assert abs(float(w.detach().float().std()) - 256 ** -0.5) < 0.01
    assert torch.equal(b.param((3,), init="zeros"), torch.zeros(3,
                       dtype=torch.bfloat16))
    a = Builder(g).param((1000,), init="ssm_a")
    assert float(a.min()) >= 0 and float(a.max()) <= np.log(16) + 1e-6
    with pytest.raises(ValueError):
        b.param((2,), init="nope")


def test_tied_embeddings_carry_across():
    cfg = ref_smoke_config("glm4-9b").replace(tie_embeddings=True)
    params, _ = ref_init_lm(cfg, jax.random.PRNGKey(1))
    assert "head" not in params
    lm = lm_from_reference(cfg, _np_tree(params), device="cpu")
    tokens = np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 8))
    want, _, _ = ref_forward(cfg, params, {"tokens": jnp.asarray(tokens)},
                             REF_RULES)
    with torch.no_grad():
        got, _, _ = forward(cfg, lm, {"tokens": tokens}, RULES)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_bfloat16_leaves_carry_across():
    cfg = ref_smoke_config("granite-moe-1b-a400m").replace(
        param_dtype="bfloat16")
    params, _ = ref_init_lm(cfg, jax.random.PRNGKey(2))
    lm = lm_from_reference(cfg, _np_tree(params), device="cpu")
    w = lm.blocks[1].moe.w_in
    assert w.dtype == torch.bfloat16
    want = np.asarray(params["blocks"]["moe"]["w_in"][1]).astype(np.float32)
    np.testing.assert_array_equal(w.detach().float().numpy(), want)
