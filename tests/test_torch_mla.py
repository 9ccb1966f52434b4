"""The port's multi-head latent attention (``repro_torch.models.attention``
MLA) against the reference's on the CPU, from the same weights: the naive
prefill path (output and the ``ckv``/``kr`` cache) and the absorbed decode
path (output and the cache written in place, per-row and scalar index),
each against the same path of the reference, for the q-LoRA and the plain
``wq`` queries; the absorbed decode against the naive forward; the 3-D
cache write; the MLA cache layout."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import attention as ref_attn
from repro.models import init_cache as ref_init_cache
from repro.models import model as ref_model
from repro.models.param import Builder as RefBuilder
from repro.models.param import finalize
from repro.parallel.sharding import Rules as RefRules
from repro_torch.models import attention, init_cache
from repro_torch.models import model
from repro_torch.models.param import Builder
from repro_torch.parallel.sharding import Rules

RULES, REF_RULES = Rules(), RefRules()
TOL = dict(rtol=2e-4, atol=2e-4)
B, T, S = 2, 9, 12


def _np(x):
    return np.asarray(x)


@pytest.fixture(scope="module", params=[32, 0], ids=["q_lora", "wq"])
def mla(request):
    """(cfg, the reference's MLA weights, the port's ``MLA``)."""
    cfg = ref_smoke_config("minicpm3-4b")
    cfg = cfg.replace(mla=dataclasses.replace(cfg.mla, q_lora=request.param))
    p, _ = finalize(ref_attn.init_attention(
        RefBuilder(jax.random.PRNGKey(1)), cfg))
    port = attention.init_attention(Builder(None, device="meta"), cfg)
    assert isinstance(port, attention.MLA)
    port.load_state_dict({k: torch.from_numpy(_np(v).copy())
                          for k, v in _flat(p)}, assign=True)
    return cfg, p, port


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _angles(cfg, positions):
    ref = ref_model._rope(cfg, jnp.asarray(positions))
    port = model._rope(cfg, torch.from_numpy(positions))
    return ref, port


def test_naive_prefill_matches_reference(mla):
    cfg, p, port = mla
    rng = np.random.default_rng(0)
    x = rng.normal(size=(B, T, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T)).copy()
    (rc, rs), (pc, ps) = _angles(cfg, pos)
    want, wc = ref_attn.attention(cfg, p, jnp.asarray(x), rc, rs, REF_RULES,
                                  return_cache=True)
    with torch.no_grad():
        got, gc = attention.attention(cfg, port, torch.from_numpy(x), pc,
                                      ps, RULES, return_cache=True)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    for k in ("ckv", "kr"):
        np.testing.assert_allclose(gc[k].numpy(), _np(wc[k]), **TOL)


@pytest.mark.parametrize("cur", [[5, 11], [3, 12], 7],
                         ids=["per-row", "row past the cache", "scalar"])
def test_absorbed_decode_matches_reference(mla, cur):
    """One token against a filled cache; a per-row index past the cache
    writes nothing to that row, a scalar one is clamped in."""
    cfg, p, port = mla
    rng = np.random.default_rng(1)
    shapes = ref_attn.init_attn_cache(cfg, B, S, jnp.float32)
    cache = {k: rng.normal(size=shape).astype(np.float32)
             for k, (shape, _) in shapes.items()}
    x = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
    offset = np.asarray(cur, np.int32)
    pos = (np.zeros((B, 1), np.int32) + (offset[:, None] if offset.ndim
                                          else offset))
    (rc, rs), (pc, ps) = _angles(cfg, pos)
    want, wc = ref_attn.attention(
        cfg, p, jnp.asarray(x), rc, rs, REF_RULES,
        cache={k: jnp.asarray(v) for k, v in cache.items()},
        cur_index=jnp.asarray(offset))
    mine = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    with torch.no_grad():
        got, gc = attention.attention(cfg, port, torch.from_numpy(x), pc,
                                      ps, RULES, cache=mine,
                                      cur_index=torch.from_numpy(offset))
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    for k in ("ckv", "kr"):
        assert gc[k] is mine[k]                  # written in place
        np.testing.assert_allclose(gc[k].numpy(), _np(wc[k]), **TOL)


def test_absorbed_decode_equals_the_naive_forward(mla):
    """Prefill the first T-1 tokens naively, decode the last one through
    the latent: its output equals the naive forward's last row."""
    cfg, _, port = mla
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(B, T, cfg.d_model)).astype(np.float32))
    pos = torch.arange(T, dtype=torch.int32).expand(B, T)
    cos, sin = model._rope(cfg, pos)
    with torch.no_grad():
        full, _ = attention.attention(cfg, port, x, cos, sin, RULES)
        _, c = attention.attention(cfg, port, x[:, :-1], cos[:, :-1],
                                   sin[:, :-1], RULES, return_cache=True)
        cache = {k: torch.zeros((B, S) + v.shape[2:]) for k, v in c.items()}
        for k, v in c.items():
            cache[k][:, :T - 1] = v
        last, _ = attention.attention(
            cfg, port, x[:, -1:], cos[:, -1:], sin[:, -1:], RULES,
            cache=cache, cur_index=torch.tensor([T - 1] * B))
    assert float((last[:, 0] - full[:, -1]).abs().max()) < 1e-4


@pytest.mark.parametrize("arch,smoke", [("deepseek-v2-236b", True),
                                        ("deepseek-v2-236b", False),
                                        ("minicpm3-4b", False)])
def test_mla_cache_layout_matches_reference(arch, smoke):
    """The compressed cache: ``ckv`` (kv_lora) and ``kr`` (qk_rope) a
    token, no per-head keys or values; shapes, dtypes and axes as the
    reference's."""
    cfg = ref_smoke_config(arch) if smoke else ref_config(arch)
    want, want_axes = ref_init_cache(cfg, 2, 40, abstract=True)
    got, axes = init_cache(cfg, 2, 40, abstract=True)
    assert axes == want_axes
    assert {n: {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
                for k, v in leaves.items()} for n, leaves in got.items()} == \
        {n: {k: (v.shape, str(v.dtype)) for k, v in leaves.items()}
         for n, leaves in want.items()}
    assert set(got["blocks"]) == {"ckv", "kr"}
