"""The port's Mamba2 block and Zamba2 hybrid (``repro_torch.models.ssm``,
the hybrid in ``models/model.py``) against the reference's on the CPU,
from the same weights: the chunked SSD against the reference's and both
recurrence oracles, the masked prefill (outputs, conv tail, state), a
decode step, the cache layouts, the engine's cache growth, and a batch
whose 2-token prompt takes its conv window from the batch's padding (the
reference's ``dynamic_slice`` wraps a negative start)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import init_cache as ref_init_cache
from repro.models import init_lm as ref_init_lm
from repro.models import ssm as ref_ssm
from repro.models.param import Builder as RefBuilder
from repro.models.param import finalize
from repro.parallel.sharding import Rules as RefRules
from repro.serve import Engine as RefEngine
from repro_torch.interop import lm_from_reference
from repro_torch.models import init_cache, ssm
from repro_torch.models.param import Builder
from repro_torch.parallel.sharding import Rules
from repro_torch.serve import Engine

RULES, REF_RULES = Rules(), RefRules()
TOL = dict(rtol=2e-4, atol=2e-4)


def _np(x):
    return np.asarray(x)


@pytest.fixture(scope="module")
def mixer():
    """(cfg, the reference's mixer weights, the port's ``Mamba``)."""
    cfg = ref_smoke_config("mamba2-370m")
    p, _ = finalize(ref_ssm.init_mamba(RefBuilder(jax.random.PRNGKey(0)),
                                       cfg))
    port = ssm.Mamba(Builder(None, device="meta"), cfg)
    port.load_state_dict({k: torch.from_numpy(_np(v).copy())
                          for k, v in p.items()}, assign=True)
    return cfg, p, port


@pytest.mark.parametrize("groups", [1, 2])
def test_ssd_chunked_matches_reference_and_recurrence(groups):
    rng = np.random.default_rng(groups)
    b, t, h, p, n, chunk = 2, 32, 4, 8, 16, 8
    x = rng.normal(size=(b, t, h, p)).astype(np.float32)
    dt = np.abs(rng.normal(size=(b, t, h))).astype(np.float32) * 0.1
    a = -np.abs(rng.normal(size=(h,))).astype(np.float32)
    bb = rng.normal(size=(b, t, groups, n)).astype(np.float32)
    cc = rng.normal(size=(b, t, groups, n)).astype(np.float32)
    args = [torch.from_numpy(v) for v in (x, dt, a, bb, cc)]
    y, s = ssm._ssd_chunked(*args, chunk)
    ry, rs = ref_ssm._ssd_chunked(*map(jnp.asarray, (x, dt, a, bb, cc)),
                                  chunk)
    np.testing.assert_allclose(y.numpy(), _np(ry), **TOL)
    np.testing.assert_allclose(s.numpy(), _np(rs), **TOL)
    oy, os_ = ssm.ssd_reference(*args)
    wy, ws = ref_ssm.ssd_reference(*map(jnp.asarray, (x, dt, a, bb, cc)))
    np.testing.assert_allclose(oy.numpy(), _np(wy), **TOL)
    np.testing.assert_allclose(os_.numpy(), _np(ws), **TOL)
    np.testing.assert_allclose(y.numpy(), oy.numpy(), **TOL)
    np.testing.assert_allclose(s.numpy(), os_.numpy(), **TOL)


# a right-padded batch's lengths, and whether seq_mask is passed
_PREFILLS = {"masked 2, 5, 9": ([2, 5, 9], True),
             "unmasked 9": ([9, 9, 9], False),
             "unmasked 2": ([2, 2, 2], False)}


@pytest.mark.parametrize("case", sorted(_PREFILLS))
def test_mamba_train_matches_reference(mixer, case):
    """Outputs, the conv tail and the state: masked, the tail of the
    2-token row is rows 6..8 of the batch (start -1 wraps to 8, clamps to
    6), as the reference takes it."""
    cfg, p, port = mixer
    lens, masked = _PREFILLS[case]
    t = max(lens)
    rng = np.random.default_rng(t)
    x = rng.normal(size=(len(lens), t, cfg.d_model)).astype(np.float32)
    mask = (np.arange(t)[None, :] < np.array(lens)[:, None]).astype(np.int32)
    kw = {"seq_mask": mask} if masked else {}
    want, wc = ref_ssm.mamba_train(
        cfg, p, jnp.asarray(x), REF_RULES, return_cache=True,
        **{k: jnp.asarray(v) for k, v in kw.items()})
    with torch.no_grad():
        got, gc = ssm.mamba_train(
            cfg, port, torch.from_numpy(x), RULES, return_cache=True,
            **{k: torch.from_numpy(v) for k, v in kw.items()})
        if masked:
            raw = ssm._split_proj(cfg, torch.from_numpy(x) @ port.w_in)[1]
            assert torch.equal(gc["conv"][0], raw[0, 6:9])
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    np.testing.assert_allclose(gc["conv"].numpy(), _np(wc["conv"]), **TOL)
    np.testing.assert_allclose(gc["ssm"].numpy(), _np(wc["ssm"]), **TOL)
    assert gc["ssm"].dtype == torch.float32


def test_masked_prefill_shorter_than_the_conv_window_raises(mixer):
    """A masked batch of 2 positions: the reference's slice of 3 rows out
    of 2 raises, and so does the port."""
    cfg, p, port = mixer
    x = np.zeros((2, 2, cfg.d_model), np.float32)
    mask = np.array([[1, 1], [1, 0]], np.int32)
    with pytest.raises(TypeError):
        ref_ssm.mamba_train(cfg, p, jnp.asarray(x), REF_RULES,
                            return_cache=True, seq_mask=jnp.asarray(mask))
    with pytest.raises(ValueError, match="conv window"):
        ssm.mamba_train(cfg, port, torch.from_numpy(x), RULES,
                        return_cache=True, seq_mask=torch.from_numpy(mask))


def test_mamba_decode_matches_reference_in_place(mixer):
    cfg, p, port = mixer
    rng = np.random.default_rng(3)
    shapes = ref_ssm.init_ssm_cache(cfg, 3, jnp.float32)
    cache = {k: rng.normal(size=shape).astype(np.float32)
             for k, (shape, _) in shapes.items()}
    x = rng.normal(size=(3, 1, cfg.d_model)).astype(np.float32)
    want, wc = ref_ssm.mamba_decode(
        cfg, p, jnp.asarray(x), {k: jnp.asarray(v) for k, v in cache.items()},
        REF_RULES)
    mine = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    with torch.no_grad():
        got, gc = ssm.mamba_decode(cfg, port, torch.from_numpy(x), mine,
                                   RULES)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    for k in ("conv", "ssm"):
        assert gc[k] is mine[k]                 # written in place
        np.testing.assert_allclose(gc[k].numpy(), _np(wc[k]), **TOL)


@pytest.mark.parametrize("arch,smoke", [("zamba2-1.2b", True),
                                        ("zamba2-1.2b", False),
                                        ("mamba2-370m", False)])
def test_cache_layout_matches_reference(arch, smoke):
    """Shapes, dtypes and logical axes of ``init_cache``: the hybrid's
    ``shared`` (one entry a shared-block application) and ``blocks``."""
    cfg = ref_smoke_config(arch) if smoke else ref_config(arch)
    want, want_axes = ref_init_cache(cfg, 2, 40, abstract=True)
    got, axes = init_cache(cfg, 2, 40, abstract=True)
    assert axes == want_axes
    assert {n: {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
                for k, v in leaves.items()} for n, leaves in got.items()} == \
        {n: {k: (v.shape, str(v.dtype)) for k, v in leaves.items()}
         for n, leaves in want.items()}
    if cfg.family == "hybrid":
        assert got["shared"]["k"].shape[0] == -(-cfg.n_layers
                                                // cfg.hybrid_period)


@pytest.fixture(scope="module", params=["mamba2-370m", "zamba2-1.2b"])
def engines(request):
    cfg = ref_smoke_config(request.param)
    params, _ = ref_init_lm(cfg, jax.random.PRNGKey(0))
    lm = lm_from_reference(cfg, jax.tree.map(np.asarray, params),
                           device="cpu")
    return (cfg, RefEngine(cfg, params, REF_RULES, max_seq=48),
            Engine(cfg, lm, max_seq=48))


def test_batch_with_a_two_token_prompt_equals_reference(engines):
    """The 2-token prompt's conv window comes from the batch's padding
    rows in both packages, so the batches' greedy tokens agree."""
    cfg, ref, port = engines
    rng = np.random.default_rng(5)
    prompts = [list(rng.integers(1, cfg.vocab_size, n))
               for n in (2, 7, 12, 5)]
    assert port.generate(prompts, max_new=6) == ref.generate(prompts,
                                                             max_new=6)


def test_engine_grows_only_the_sequence_axes(engines, monkeypatch):
    """Decode sees the cache ``init_cache`` gives at ``max_seq``: the
    attention leaves grown, the conv window and the state as they were."""
    cfg, _, port = engines
    seen = []
    real = port._decode

    def rec(cache, tok, cur):
        seen.append({n: {k: tuple(v.shape) for k, v in leaves.items()}
                     for n, leaves in cache.items()})
        return real(cache, tok, cur)

    monkeypatch.setattr(port, "_decode", rec)
    port.generate([[1, 2, 3, 4], [5, 6, 7]], max_new=3)
    want, _ = init_cache(cfg, 2, port.max_seq, abstract=True)
    assert seen and all(s == {n: {k: tuple(v.shape) for k, v in l.items()}
                              for n, l in want.items()} for s in seen)
