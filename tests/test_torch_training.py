"""The port's training slice (``repro_torch.optim``, ``.training``,
``.launch.train``) against the reference's on the CPU: AdamW, clipping and
the schedule on the same inputs; three train steps of every family's
smoke config from the reference's weights (``interop.lm_from_reference``)
on ``TokenStream`` batches (seeded frames for musicgen); the port's
'pallas' dispatch and its three ``remat`` modes bit for bit; gradient
accumulation; the fault-tolerant ``train_loop`` with a cold restart and a
resume; snapshots crossing between the packages, bfloat16 ones bit for
bit; and the command line.

Tolerances: every step's loss within 1e-5 relative and its global
gradient norm within 1e-4 relative (float32 against float32, sums in
other orders); the parameters after three steps within the reference's own
accumulation bound, 5e-3 (``tests/test_training.py``), and each
parameter's change from its initial value within 5e-5 of the reference's
change (the summed learning rate, about 1.9e-3, is the size of that
change), save at most 8 elements that may be off by up to twice the summed
learning rate — AdamW's normalised step is about ``sign(g)``, and a
gradient element near 0 can take either sign in two float32
implementations; the moments ``m`` and ``v`` within 1e-3 of each leaf's
largest; AdamW alone, on the same gradients, within 1e-6.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import checkpoint as ref_ckpt
from repro import optim as ref_optim
from repro.configs import get_smoke_config as ref_smoke_config
from repro.launch import train as ref_train
from repro.models import init_lm as ref_init_lm
from repro.parallel.sharding import Rules as RefRules
from repro.training import Hyper as RefHyper
from repro.training import make_train_step as ref_make_train_step
from repro_torch import optim
from repro_torch.checkpoint import CheckpointManager, read_manifest, \
    restore, save
from repro_torch.interop import (lm_from_reference, lm_to_reference,
                                 named_from_reference, named_to_reference,
                                 opt_state_from_reference,
                                 opt_state_to_reference, to_device, to_numpy)
from repro_torch.launch import train as port_train
from repro_torch.models import init_lm, lm_loss
from repro_torch.models import moe as moe_mod
from repro_torch.parallel.sharding import Rules
from repro_torch.training import Hyper, make_eval_step, make_train_step

RULES, REF_RULES = Rules(), RefRules()
ARCHS = [("glm4-9b", "xla"), ("granite-moe-1b-a400m", "xla"),
         ("granite-moe-1b-a400m", "pallas"), ("minicpm3-4b", "xla"),
         ("mamba2-370m", "xla"), ("zamba2-1.2b", "xla"),
         ("musicgen-large", "xla"), ("qwen2-vl-2b", "xla")]
STEPS, B, S = 3, 2, 16
LOSS_RTOL, GNORM_RTOL, PARAM_ATOL = 1e-5, 1e-4, 5e-3
DELTA_ATOL, DELTA_OUTLIERS, MOMENT_RTOL = 5e-5, 8, 1e-3
# a one-step warm-up, so that steps 1 and 2 move every parameter by about
# 1e-3; shared by every test (the train loops get it too) so the reference
# compiles each arch's step once
HYPER = dict(lr=1e-3, warmup=1, total_steps=5)
LOOP = dict(steps=5, batch=B, seq=S, ckpt_every=2, fail_at=(1, 3),
            verbose=False)
_REF_STEPS = {}


def _ref_step(cfg, impl="xla"):
    """The reference's jitted train step at ``HYPER``, one an arch and
    dispatch, so each compiles once a module."""
    key = (cfg.name, impl)
    if key not in _REF_STEPS:
        _REF_STEPS[key] = jax.jit(ref_make_train_step(
            cfg, REF_RULES, RefHyper(**HYPER, sort_impl=impl)))
    return _REF_STEPS[key]


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _batches(cfg, n, b=B, s=S):
    it = port_train._make_batch_iter(cfg, b, s)
    return [next(it) for _ in range(n)]


def _bits16(a) -> np.ndarray:
    a = to_numpy(a) if isinstance(a, torch.Tensor) else np.asarray(a)
    return np.ascontiguousarray(a).view(np.int16)


def _assert_trees_close(port_ref_tree, ref_tree, atol):
    got = jax.tree_util.tree_flatten_with_path(port_ref_tree)[0]
    want = dict(jax.tree_util.tree_flatten_with_path(ref_tree)[0])
    assert len(got) == len(want)
    for path, leaf in got:
        np.testing.assert_allclose(leaf, np.asarray(want[path]), rtol=0,
                                   atol=atol, err_msg=str(path))


def _summed_lr(steps):
    lr = optim.cosine_schedule(HYPER["lr"], HYPER["warmup"],
                               HYPER["total_steps"])
    return sum(float(lr(s)) for s in steps)


def _assert_updates_close(port_tree, ref_tree, init_tree, summed_lr):
    """Each leaf's change from ``init_tree`` within ``DELTA_ATOL`` of the
    reference's change; at most ``DELTA_OUTLIERS`` elements in all may be
    off by more, and none by more than twice the summed learning rate
    (trap: AdamW's ``sign(g)`` of a gradient element near 0)."""
    assert DELTA_ATOL < summed_lr / 10
    got = jax.tree_util.tree_flatten_with_path(port_tree)[0]
    want = dict(jax.tree_util.tree_flatten_with_path(ref_tree)[0])
    init = dict(jax.tree_util.tree_flatten_with_path(init_tree)[0])
    assert len(got) == len(want) == len(init)
    outliers, moved, size = 0, 0, 0
    for path, leaf in got:
        d_ref = np.asarray(want[path]) - init[path]
        err = np.abs((leaf - init[path]) - d_ref)
        assert err.max() <= 2 * summed_lr * 1.01, str(path)
        outliers += int((err > DELTA_ATOL).sum())
        moved += int((np.abs(d_ref) > DELTA_ATOL).sum())
        size += err.size
    assert outliers <= DELTA_OUTLIERS
    assert moved > size / 2       # most changes stand above the bound


def _assert_moments_close(port_tree, ref_tree):
    got = jax.tree_util.tree_flatten_with_path(port_tree)[0]
    want = dict(jax.tree_util.tree_flatten_with_path(ref_tree)[0])
    assert len(got) == len(want)
    for path, leaf in got:
        ref = np.asarray(want[path])
        np.testing.assert_allclose(leaf, ref, rtol=0,
                                   atol=MOMENT_RTOL * np.abs(ref).max(),
                                   err_msg=str(path))


def _port_steps(cfg, lm, batches, hyper, start=0):
    opt = optim.init_opt_state(lm)
    step_fn = make_train_step(cfg, RULES, hyper)
    metrics = []
    for i, b in enumerate(batches):
        lm, opt, m = step_fn(lm, opt, b, start + i)
        metrics.append({k: float(v) for k, v in m.items()})
    return lm, opt, metrics


@pytest.fixture(scope="module", params=ARCHS, ids=lambda a: "-".join(a))
def ref_run(request):
    """The reference's weights and three jitted steps of ``arch`` — built
    once a module."""
    arch, impl = request.param
    cfg = ref_smoke_config(arch)
    params, _ = ref_init_lm(cfg, jax.random.PRNGKey(0))
    init = _np_tree(params)
    step_fn = _ref_step(cfg, impl)
    opt = ref_optim.init_opt_state(params)
    batches = _batches(cfg, STEPS)
    metrics = []
    for i, b in enumerate(batches):
        params, opt, m = step_fn(params, opt, jax.tree.map(jnp.asarray, b),
                                 jnp.int32(i))
        metrics.append({k: float(v) for k, v in m.items()})
    return dict(arch=arch, impl=impl, cfg=cfg, init=init, batches=batches,
                metrics=metrics, params=_np_tree(params), opt=_np_tree(opt))


# ---------------- the optimizer ----------------

@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_adamw_matches_reference(moment_dtype):
    """Three updates from the same gradients: parameters and moments
    within 1e-6, the count the reference's."""
    rng = np.random.default_rng(0)
    shapes = {"w": (16, 8), "b": (8,), "emb": (5, 3, 4)}
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    cfg = optim.AdamWConfig(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)
    ref_cfg = ref_optim.AdamWConfig(b1=0.9, b2=0.95, eps=1e-8,
                                    weight_decay=0.1)
    ref_p = {k: jnp.asarray(v) for k, v in params.items()}
    ref_st = ref_optim.init_opt_state(ref_p, getattr(jnp, moment_dtype))
    p = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    st = optim.init_opt_state(p, getattr(torch, moment_dtype))
    for step, lr in enumerate((1e-2, 3e-3, 5e-2)):
        g = {k: rng.normal(size=s).astype(np.float32)
             for k, s in shapes.items()}
        ref_p, ref_st = ref_optim.adamw_update(
            {k: jnp.asarray(v) for k, v in g.items()}, ref_st, ref_p,
            jnp.float32(lr), ref_cfg)
        p, st = optim.adamw_update({k: torch.from_numpy(v)
                                    for k, v in g.items()}, st, p, lr, cfg)
        assert int(st["count"]) == int(ref_st["count"]) == step + 1
    assert st["count"].dtype == torch.int32
    for k in shapes:
        np.testing.assert_allclose(p[k].numpy(), np.asarray(ref_p[k]),
                                   rtol=0, atol=1e-6)
        for mom in ("m", "v"):
            assert st[mom][k].dtype == getattr(torch, moment_dtype)
            np.testing.assert_allclose(
                st[mom][k].float().numpy(),
                np.asarray(ref_st[mom][k]).astype(np.float32),
                rtol=0, atol=1e-6)


def test_adamw_keeps_bfloat16_parameters_in_bfloat16():
    p = {"w": torch.ones(4, 4, dtype=torch.bfloat16)}
    st = optim.init_opt_state(p)
    optim.adamw_update({"w": torch.full((4, 4), 0.5, dtype=torch.bfloat16)},
                       st, p, 1e-2, optim.AdamWConfig())
    assert p["w"].dtype == torch.bfloat16 and st["m"]["w"].dtype == \
        torch.float32
    assert optim.opt_state_axes({"w": ("a", "b")}) == ref_optim.opt_state_axes(
        {"w": ("a", "b")})


@pytest.mark.parametrize("max_norm", [1.0, 1e9, 0.05])
def test_clip_by_global_norm_matches_reference(max_norm):
    rng = np.random.default_rng(1)
    tree = {"a": rng.normal(size=(7, 5)).astype(np.float32) * 3,
            "b": rng.normal(size=(11,)).astype(np.float32),
            "c": rng.normal(size=(2, 3, 4)).astype(np.float32)}
    want, want_g = ref_optim.clip_by_global_norm(
        {k: jnp.asarray(v) for k, v in tree.items()}, max_norm)
    got, got_g = optim.clip_by_global_norm(
        {k: torch.from_numpy(v) for k, v in tree.items()}, max_norm)
    np.testing.assert_allclose(float(got_g), float(want_g), rtol=1e-6)
    for k in tree:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-7)
    bf = {"w": torch.from_numpy(tree["a"]).to(torch.bfloat16)}
    out, _ = optim.clip_by_global_norm(bf, max_norm)
    assert out["w"].dtype == torch.bfloat16


def test_cosine_schedule_matches_reference():
    for base, warmup, total, frac in ((1.0, 10, 110, 0.1), (3e-4, 100, 10_000,
                                                              0.1),
                                      (1e-3, 0, 1, 0.0), (2.0, 5, 5, 0.3)):
        want = ref_optim.cosine_schedule(base, warmup, total, frac)
        got = optim.cosine_schedule(base, warmup, total, frac)
        for step in (0, 1, 3, 5, 9, 10, 11, 50, 60, 109, 110, 200, 9_999):
            g = got(step)
            assert g.dtype == torch.float32 and g.dim() == 0
            np.testing.assert_allclose(float(g), float(want(step)),
                                       rtol=2e-7, atol=0)


# ---------------- one train step a family ----------------

def test_train_steps_match_reference(ref_run):
    """Three steps from the reference's weights: every step's loss, its
    parts, gradient norm and learning rate; the parameters after three
    steps and their change from the initial weights; the moments."""
    cfg = ref_run["cfg"]
    lm = lm_from_reference(cfg, ref_run["init"], device="cpu")
    lm, opt, metrics = _port_steps(cfg, lm, ref_run["batches"],
                                   Hyper(**HYPER, sort_impl=ref_run["impl"]))
    want = ref_run["metrics"]
    assert set(metrics[0]) == set(want[0]) == {"ce", "aux", "loss",
                                               "grad_norm", "lr"}
    for got, ref in zip(metrics, want, strict=True):
        for k in ("loss", "ce"):
            np.testing.assert_allclose(got[k], ref[k], rtol=LOSS_RTOL)
        np.testing.assert_allclose(got["aux"], ref["aux"], rtol=LOSS_RTOL,
                                   atol=1e-7)
        np.testing.assert_allclose(got["grad_norm"], ref["grad_norm"],
                                   rtol=GNORM_RTOL)
        # the cosine's float32 may differ by an ulp, as in the schedule test
        np.testing.assert_allclose(got["lr"], ref["lr"], rtol=2e-7, atol=0)
    assert all(np.isfinite(m["loss"]) for m in metrics)
    assert metrics[1]["lr"] > 0 and metrics[2]["lr"] > 0
    params = lm_to_reference(lm)
    _assert_trees_close(params, ref_run["params"], PARAM_ATOL)
    _assert_updates_close(params, ref_run["params"], ref_run["init"],
                          _summed_lr(range(STEPS)))
    port_opt = opt_state_to_reference(opt)
    assert int(port_opt["count"]) == int(ref_run["opt"]["count"]) == STEPS
    for mom in ("m", "v"):
        _assert_moments_close(port_opt[mom], ref_run["opt"][mom])


def _grads(cfg, lm, batch, sort_impl="xla"):
    names, params = zip(*lm.named_parameters())
    loss, _ = lm_loss(cfg, lm, batch, RULES, sort_impl=sort_impl)
    return loss, dict(zip(names, torch.autograd.grad(loss, params)))


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and torch.equal(
        a.contiguous().view(torch.int32 if a.element_size() == 4
                            else torch.int16),
        b.contiguous().view(torch.int32 if b.element_size() == 4
                            else torch.int16))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pallas_dispatch_trains_bit_identical_to_xla(dtype):
    """Granite's smoke config: the kernels' dispatch ('pallas', their plain
    versions here) and the stable argsort ('xla') give the same loss,
    gradients and parameters after three steps, bit for bit."""
    cfg = ref_smoke_config("granite-moe-1b-a400m").replace(
        param_dtype=dtype, compute_dtype=dtype)
    batches = _batches(cfg, STEPS)
    out = {}
    for impl in ("xla", "pallas"):
        lm = init_lm(cfg, seed=0, device="cpu")
        loss, grads = _grads(cfg, lm, batches[0], impl)
        lm, opt, metrics = _port_steps(cfg, lm, batches,
                                       Hyper(**HYPER, sort_impl=impl))
        out[impl] = loss, grads, dict(lm.named_parameters()), metrics
    (l0, g0, p0, m0), (l1, g1, p1, m1) = out["xla"], out["pallas"]
    assert _same_bits(l0, l1) and m0 == m1
    assert all(_same_bits(g0[k], g1[k]) for k in g0)
    assert all(_same_bits(p0[k].detach(), p1[k].detach()) for k in p0)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "zamba2-1.2b",
                                  "minicpm3-4b"])
def test_remat_modes_are_bit_identical(arch, monkeypatch):
    """'none', 'full' and 'dots' give the same loss and gradients, bit for
    bit; 'full' and 'dots' run each MoE layer's dispatch sort again in the
    backward pass (the recompute), 'none' does not."""
    base = ref_smoke_config(arch)
    batch = _batches(base, 1)[0]
    sorts, real = [], moe_mod._sort_assignments

    def counted(*args):
        sorts.append(1)
        return real(*args)

    monkeypatch.setattr(moe_mod, "_sort_assignments", counted)
    out = {}
    for remat in ("none", "full", "dots"):
        cfg = base.replace(remat=remat)
        lm = init_lm(cfg, seed=0, device="cpu")
        sorts.clear()
        out[remat] = _grads(cfg, lm, batch) + (len(sorts),)
    loss, grads, n_sorts = out["none"]
    n_moe = base.n_layers - base.moe.first_dense if base.moe else 0
    assert n_sorts == n_moe
    for remat in ("full", "dots"):
        l, g, n = out[remat]
        assert _same_bits(loss, l)
        assert g.keys() == grads.keys()
        assert all(_same_bits(grads[k], g[k]) for k in grads), remat
        assert n == 2 * n_moe


def test_remat_is_inert_without_autograd():
    cfg = ref_smoke_config("granite-moe-1b-a400m")
    batch = _batches(cfg, 1)[0]
    lm = init_lm(cfg, seed=0, device="cpu")
    with torch.no_grad():
        want = lm_loss(cfg, lm, batch, RULES)[0]
        got = lm_loss(cfg.replace(remat="dots"), lm, batch, RULES)[0]
    assert _same_bits(want, got)
    with pytest.raises(ValueError, match="remat"):
        lm_loss(cfg.replace(remat="most"), lm, batch, RULES)


def test_grad_accumulation_matches_reference():
    """``accum=4`` over a batch of 8: the reference's accumulation step
    (float32 sums, ``aux`` reported as 0) and the port's."""
    cfg = ref_smoke_config("granite-moe-1b-a400m")
    params, _ = ref_init_lm(cfg, jax.random.PRNGKey(0))
    init = _np_tree(params)
    batch = _batches(cfg, 1, b=8, s=8)[0]
    hyper = dict(HYPER, accum=4)
    ref_step = jax.jit(ref_make_train_step(cfg, REF_RULES, RefHyper(**hyper)))
    rp, ropt, rm = ref_step(params, ref_optim.init_opt_state(params),
                            jax.tree.map(jnp.asarray, batch), jnp.int32(1))
    lm = lm_from_reference(cfg, init, device="cpu")
    lm, _, metrics = _port_steps(cfg, lm, [batch], Hyper(**hyper), start=1)
    m = metrics[0]
    assert m["aux"] == float(rm["aux"]) == 0.0
    np.testing.assert_allclose(m["loss"], float(rm["loss"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(m["grad_norm"], float(rm["grad_norm"]),
                               rtol=GNORM_RTOL)
    params = lm_to_reference(lm)
    _assert_trees_close(params, _np_tree(rp), PARAM_ATOL)
    _assert_updates_close(params, _np_tree(rp), init, _summed_lr([1]))


def test_eval_step_is_the_loss():
    cfg = ref_smoke_config("glm4-9b")
    lm = init_lm(cfg, seed=0, device="cpu")
    batch = _batches(cfg, 1)[0]
    out = make_eval_step(cfg, RULES)(lm, batch)
    assert set(out) == {"ce", "aux", "loss"} and not out["loss"].requires_grad
    with torch.no_grad():
        assert _same_bits(out["loss"], lm_loss(cfg, lm, batch, RULES)[0])


# ---------------- interop: the reference's layout ----------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_weights_and_opt_state_round_trip_the_reference_layout(ref_run,
                                                              dtype):
    """``lm_to_reference(lm_from_reference(w))`` is ``w``, leaf for leaf
    and bit for bit (bfloat16 as ``V2`` records), and the AdamW state
    crosses both ways the same."""
    cfg = ref_run["cfg"].replace(param_dtype=dtype)
    want = jax.tree.map(lambda a: a.astype(getattr(ml_dtypes, dtype, dtype)),
                        ref_run["init"])
    lm = lm_from_reference(cfg, want, device="cpu")
    back = lm_to_reference(lm)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for got, ref in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        assert got.shape == ref.shape
        assert got.dtype == (np.dtype("V2") if dtype == "bfloat16"
                             else ref.dtype)
        assert got.tobytes() == ref.tobytes()
    ref_opt = {"m": want, "v": jax.tree.map(lambda a: a * 2, want),
               "count": np.int32(7)}
    opt = opt_state_from_reference(ref_opt, device="cpu")
    assert opt["m"].keys() == dict(lm.named_parameters()).keys()
    assert opt["count"].dtype == torch.int32 and int(opt["count"]) == 7
    again = opt_state_to_reference(opt)
    for got, ref in zip(jax.tree.leaves(again), jax.tree.leaves(ref_opt)):
        assert got.tobytes() == np.asarray(ref).tobytes()


def test_named_tensors_stack_by_layer_into_the_reference_layout():
    t = {f"first.{i}.ln.w": torch.full((2,), float(i)) for i in (1, 0)}
    t.update({f"blocks.{i}.moe.w_in": torch.full((3, 1), float(i))
              for i in (2, 0, 1)})
    t["final_norm.w"] = torch.ones(4)
    tree = named_to_reference(t)
    assert tree.keys() == {"first", "blocks", "final_norm"}
    np.testing.assert_array_equal(tree["first"]["ln"]["w"][:, 0], [0, 1])
    np.testing.assert_array_equal(tree["blocks"]["moe"]["w_in"][:, 0, 0],
                                  [0, 1, 2])
    assert tree["final_norm"]["w"].shape == (4,)
    back = named_from_reference(tree)
    assert back.keys() == t.keys()
    assert all(torch.equal(back[k], t[k]) for k in t)


def test_bfloat16_crosses_by_its_bits():
    bits = np.array([0x3FC0, 0x8000, 0x0000, 0x7F80, 0xFF80, 0x7FC1, 0xFFFF,
                     0x0001], np.uint16).view(np.int16)
    t = torch.from_numpy(bits.copy()).view(torch.bfloat16)
    a = to_numpy(t)
    assert a.dtype == np.dtype("V2")
    np.testing.assert_array_equal(a.view(np.int16), bits)
    for arr in (a, bits.view(ml_dtypes.bfloat16)):
        back = to_device(arr, "cpu")
        assert back.dtype == torch.bfloat16
        assert torch.equal(back.view(torch.int16), t.view(torch.int16))
    assert to_numpy(torch.ones(2, requires_grad=True)).tolist() == [1.0, 1.0]


# ---------------- snapshots ----------------

def _bf16_tree(seed):
    cfg = ref_smoke_config("granite-moe-1b-a400m").replace(
        param_dtype="bfloat16")
    params, _ = ref_init_lm(cfg, jax.random.PRNGKey(seed))
    return {"params": params,
            "opt": ref_optim.init_opt_state(params, jnp.bfloat16)}


def test_reference_bfloat16_snapshot_restores_in_the_port_bit_for_bit(
        tmp_path):
    tree = _bf16_tree(4)
    ref_ckpt.save(str(tmp_path), 3, tree)
    target = jax.tree.map(lambda a: torch.empty(a.shape, device="meta"),
                          tree)
    got = restore(str(tmp_path), 3, target, device="cpu")
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(tree)):
        assert g.dtype == (torch.bfloat16 if w.dtype == jnp.bfloat16
                           else torch.int32)
        assert to_numpy(g).tobytes() == np.asarray(w).tobytes()
    with pytest.raises(TypeError):        # the reference cannot (ROADMAP)
        ref_ckpt.restore(str(tmp_path), 3, tree)


def test_port_bfloat16_snapshot_is_the_reference_bytes(tmp_path):
    """The port's bf16 snapshot: the reference's files byte for byte and
    its manifest, and it restores in the port bit for bit — through the
    manager's asynchronous save too."""
    tree = _bf16_tree(5)
    ref_ckpt.save(str(tmp_path / "ref"), 1, tree)
    cfg = ref_smoke_config("granite-moe-1b-a400m").replace(
        param_dtype="bfloat16")
    lm = lm_from_reference(cfg, _np_tree(tree["params"]), device="cpu")
    opt = opt_state_from_reference(_np_tree(tree["opt"]), device="cpu")
    port_tree = {"params": lm_to_reference(lm),
                 "opt": opt_state_to_reference(opt)}
    save(str(tmp_path / "port"), 1, port_tree)
    mgr = CheckpointManager(str(tmp_path / "async"))
    mgr.save(1, {"params": dict(lm.named_parameters()), "opt": opt})
    mgr.wait()
    assert read_manifest(str(tmp_path / "port"), 1) == \
        read_manifest(str(tmp_path / "ref"), 1)
    leaves = read_manifest(str(tmp_path / "ref"), 1)["leaves"]
    assert {e["dtype"] for e in leaves} == {"bfloat16", "int32"}
    for e in leaves:
        with open(tmp_path / "ref" / "step_1" / e["file"], "rb") as f:
            want = f.read()
        with open(tmp_path / "port" / "step_1" / e["file"], "rb") as f:
            assert f.read() == want, e["name"]
    got = restore(str(tmp_path / "port"), 1, port_tree, device="cpu")
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(tree)):
        assert to_numpy(g).tobytes() == np.asarray(w).tobytes()
    named = dict(lm.named_parameters())
    back = restore(str(tmp_path / "async"), 1,
                   {"params": named, "opt": opt}, device="cpu")
    assert all(_same_bits(back["params"][k], named[k].detach())
               for k in named)
    manifest = read_manifest(str(tmp_path / "async"), 1)
    assert {e["dtype"] for e in manifest["leaves"]} == {"bfloat16", "int32"}


# ---------------- the train loop ----------------

@pytest.fixture(scope="module")
def loops(tmp_path_factory):
    """The reference's and the port's ``train_loop`` of Granite's smoke
    config with the same arguments: a failure at step 1, before any
    snapshot (a cold restart), and at step 3 (a restore of step 2);
    snapshots every 2 steps, of which steps 2 and 4 are kept."""
    cfg = ref_smoke_config("granite-moe-1b-a400m")
    out = {"cfg": cfg}
    for name, mod, kw in (("ref", ref_train, {"hyper": RefHyper(**HYPER)}),
                          ("port", port_train, {"device": "cpu",
                                                "hyper": Hyper(**HYPER)})):
        d = str(tmp_path_factory.mktemp(name))
        _, losses, events = mod.train_loop(cfg, ckpt_dir=d, **LOOP, **kw)
        out[name] = dict(dir=d, losses=losses, events=events)
    return out


def test_train_loop_recovers_as_the_reference(loops):
    ref, port = loops["ref"], loops["port"]
    assert [e.step for e in port["events"]] == \
        [e.step for e in ref["events"]] == [0, 2]
    assert all(e.devices_before == e.devices_after == 1
               for e in port["events"])
    assert len(port["losses"]) == len(ref["losses"]) == 1 + 3 + 3
    assert np.isfinite(port["losses"]).all()
    # the cold restart and the resume both begin a new stream: batch 0
    assert port["losses"][1] == port["losses"][0]
    for name in ("ref", "port"):
        assert sorted(os.listdir(loops[name]["dir"])) == ["step_2", "step_4"]
    assert read_manifest(port["dir"], 4) == read_manifest(ref["dir"], 4)


def _fresh_state(cfg):
    lm = init_lm(cfg, seed=1, device="cpu")
    return lm, optim.init_opt_state(lm)


def _target(lm, opt):
    return {"params": lm_to_reference(lm),
            "opt": opt_state_to_reference(opt)}


def _port_resume(cfg, directory, step):
    """A fresh port model and optimizer restoring ``directory``'s snapshot
    ``step``, then the loop's remaining steps on a new stream."""
    lm, opt = _fresh_state(cfg)
    tree = restore(directory, step, _target(lm, opt), device="cpu")
    port_train.load_snapshot(lm, opt, tree)
    step_fn = make_train_step(cfg, RULES, Hyper(**HYPER))
    losses = []
    for i, b in enumerate(_batches(cfg, LOOP["steps"] - step,
                                   s=LOOP["seq"])):
        lm, opt, m = step_fn(lm, opt, b, step + i)
        losses.append(float(m["loss"]))
    return lm, opt, losses


def _ref_resume(cfg, directory, step):
    params, _ = ref_init_lm(cfg, jax.random.PRNGKey(1))
    tree = ref_ckpt.restore(directory, step, {
        "params": params, "opt": ref_optim.init_opt_state(params)})
    params, opt = tree["params"], tree["opt"]
    step_fn = _ref_step(cfg)
    losses = []
    for i, b in enumerate(_batches(cfg, LOOP["steps"] - step,
                                   s=LOOP["seq"])):
        params, opt, m = step_fn(params, opt, jax.tree.map(jnp.asarray, b),
                                 jnp.int32(step + i))
        losses.append(float(m["loss"]))
    return losses


def test_resumed_segment_equals_a_fresh_run_from_its_snapshot(loops):
    """The loop's losses after its restore of step 2 are those of fresh
    objects that restore the same snapshot and run on — bit for bit."""
    cfg, port = loops["cfg"], loops["port"]
    _, _, losses = _port_resume(cfg, port["dir"], 2)
    assert losses == port["losses"][-3:]


def test_reference_snapshot_resumes_in_the_port(loops):
    """The reference's float32 snapshot at step 2, restored by the port
    (every leaf bit for bit) and trained on: the reference's resumed
    losses."""
    cfg, ref = loops["cfg"], loops["ref"]
    lm, opt, losses = _port_resume(cfg, ref["dir"], 2)
    np.testing.assert_allclose(losses, ref["losses"][-3:], rtol=1e-4)
    np.testing.assert_allclose(losses[0], ref["losses"][-3], rtol=LOSS_RTOL)
    lm2, opt2 = _fresh_state(cfg)
    port_train.load_snapshot(lm2, opt2, restore(
        ref["dir"], 4, _target(lm2, opt2), device="cpu"))
    want = ref_ckpt.restore(ref["dir"], 4, jax.tree.map(
        np.asarray, _target(lm2, opt2)))
    for g, w in zip(jax.tree.leaves(_target(lm2, opt2)),
                    jax.tree.leaves(want)):
        np.testing.assert_array_equal(g, np.asarray(w))


def test_port_snapshot_resumes_in_the_reference(loops):
    cfg, port = loops["cfg"], loops["port"]
    losses = _ref_resume(cfg, port["dir"], 2)
    np.testing.assert_allclose(losses, port["losses"][-3:], rtol=1e-4)
    np.testing.assert_allclose(losses[0], port["losses"][-3], rtol=LOSS_RTOL)


def test_train_loop_without_snapshots_runs_every_step():
    cfg = ref_smoke_config("mamba2-370m")
    _, losses, events = port_train.train_loop(
        cfg, steps=3, batch=2, seq=8, verbose=False, device="cpu")
    assert len(losses) == 3 and events == [] and np.isfinite(losses).all()


def test_cli_trains_the_smoke_config_on_the_cpu(capsys, tmp_path):
    port_train.main(["--arch", "granite-moe-1b-a400m", "--smoke", "--device",
                     "cpu", "--steps", "3", "--seq", "8", "--sort-impl",
                     "pallas", "--ckpt-dir", str(tmp_path), "--fail-at",
                     "2"])
    out = capsys.readouterr().out
    assert "final loss" in out and "1 recoveries" in out
    assert os.listdir(tmp_path) == []      # ckpt_every 10: no snapshot
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if torch.cuda.is_available():
            raise RuntimeError("no CUDA device (the card is here)")
        port_train.main(["--arch", "granite-moe-1b-a400m", "--smoke",
                         "--steps", "1"])
