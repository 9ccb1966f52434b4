"""The port's launch layer against the reference's (``repro.launch``):
parameter counts, the closed-form analytics of every cell under every
hillclimb lever, the roofline arithmetic, the accumulation table and the
cell coverage, the abstract inputs and their placements on four meshes,
and the dry run of three smoke archs' train, prefill and decode steps over
a fake ``(4, 2)`` process group; and the sharded ``Engine.generate`` (the
C8 repair) on 2 gloo ranks of a ``(1, 2)`` mesh."""

import dataclasses
import functools
import json
import math

import pytest
import torch
import torch.distributed as dist

import _torch_mesh
from repro.configs import ARCH_IDS as REF_ARCH_IDS
from repro.configs import SHAPES as REF_SHAPES
from repro.configs import cells_for as ref_cells_for
from repro.configs import get_config as ref_get_config
from repro.launch import analytics as ref_analytics
from repro.launch import hillclimb as ref_hillclimb
from repro.launch import hw as ref_hw
from repro.launch import specs as ref_specs
from repro.launch.dryrun import TRAIN_ACCUM as REF_TRAIN_ACCUM
from repro.launch.dryrun import roofline_terms as ref_roofline_terms
from repro.models import model as ref_model
from repro.parallel.sharding import Rules as RefRules
from repro_torch.configs import (ARCH_IDS, SHAPES, ShapeCell, cells_for,
                                 get_config, get_smoke_config)
from repro_torch.launch import analytics, dryrun, enrich, hillclimb, hw, specs
from repro_torch.parallel.sharding import Rules
from test_torch_parallel import MESHES, STACKS, _per_layer, _RefMesh

# ---------------- parameter counts, analytics, roofline ----------------


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_count_params_matches_reference(arch):
    assert specs.count_params(get_config(arch)) == \
        ref_specs.count_params(ref_get_config(arch))


@functools.cache
def _counts(arch):
    return specs.count_params(get_config(arch))


def _levers():
    """Every distinct lever setting of the hillclimb's variants, and the
    baseline of each cell (its ``TRAIN_ACCUM``)."""
    out = set()
    for variants in hillclimb.VARIANTS.values():
        for v in variants:
            out.add((v["accum"], v.get("sp", False),
                     v.get("weights_resident", False), v.get("int8", False)))
    return sorted(out)


_HW_FIELDS = {"roofline", "step_time_bound_s", "roofline_fraction",
              "budget_gib", "fits"}
_CELLS = [(a, c.name, mp) for a in ARCH_IDS for c in cells_for(get_config(a))
          for mp in (False, True)]


@pytest.fixture
def cached_counts(monkeypatch):
    """Both analytics modules read each arch's counts once (the test of
    ``count_params`` above holds them equal)."""
    by_name = {get_config(a).name: a for a in ARCH_IDS}
    monkeypatch.setattr(analytics, "_param_count",
                        lambda cfg: _counts(by_name[cfg.name]))
    monkeypatch.setattr(ref_analytics, "_param_count",
                        lambda cfg: _counts(by_name[cfg.name]))


def _both(arch, shape, mp, accum, sp, wr, int8):
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    cell, ref_cell = SHAPES[shape], REF_SHAPES[shape]
    got = (analytics.cell_analytics(cfg, cell, mp, accum, sp, wr, int8),
           analytics.hbm_capacity_check(cfg, cell, mp, accum, sp, wr))
    want = (ref_analytics.cell_analytics(ref_cfg, ref_cell, mp, accum, sp,
                                         wr, int8),
            ref_analytics.hbm_capacity_check(ref_cfg, ref_cell, mp, accum,
                                             sp, wr))
    return got, want


@pytest.mark.parametrize("arch,shape,mp", _CELLS,
                         ids=[f"{a}-{s}-{'pod' if m else '16x16'}"
                              for a, s, m in _CELLS])
def test_cell_analytics_match_reference(arch, shape, mp, cached_counts,
                                        monkeypatch):
    """Every field that does not read ``hw`` equals the reference's bit
    for bit; with the port's ``hw`` set to the reference's v5e numbers,
    every field does."""
    levers = _levers() + [(REF_TRAIN_ACCUM.get(arch, 1), False, False,
                           False)]
    for lv in levers:
        got, want = _both(arch, shape, mp, *lv)
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in g:
                if k not in _HW_FIELDS:
                    assert g[k] == w[k], (lv, k)
    for name, value in (("PEAK_FLOPS_BF16", ref_hw.PEAK_FLOPS_BF16),
                        ("HBM_BW", ref_hw.HBM_BW),
                        ("NVLINK_BW", ref_hw.ICI_BW),
                        ("HBM_BYTES", ref_hw.HBM_BYTES)):
        monkeypatch.setattr(hw, name, value)
    for lv in levers:
        got, want = _both(arch, shape, mp, *lv)
        assert got == want, lv


def test_h100_constants():
    assert (hw.PEAK_FLOPS_BF16, hw.HBM_BW, hw.NVLINK_BW, hw.HBM_BYTES) == \
        (989e12, 3.35e12, 450e9, 80e9)
    assert hw.COLLECTIVE_MULTIPLIER == ref_hw.COLLECTIVE_MULTIPLIER


def test_device_properties_needs_a_card():
    if torch.cuda.is_available():
        assert "name" in hw.device_properties()
    else:
        with pytest.raises(RuntimeError, match="no"):
            hw.device_properties()


def test_roofline_terms(monkeypatch):
    coll = {"all-reduce": {"count": 1, "bytes": hw.NVLINK_BW}}
    t = dryrun.roofline_terms(hw.PEAK_FLOPS_BF16, hw.HBM_BW, coll)
    assert t["compute_s"] == pytest.approx(1.0)
    assert t["memory_s"] == pytest.approx(1.0)
    assert t["collective_s"] == pytest.approx(2.0)
    assert t["bottleneck"] == "collective_s"
    monkeypatch.setattr(hw, "PEAK_FLOPS_BF16", ref_hw.PEAK_FLOPS_BF16)
    monkeypatch.setattr(hw, "HBM_BW", ref_hw.HBM_BW)
    monkeypatch.setattr(hw, "NVLINK_BW", ref_hw.ICI_BW)
    coll = {k: {"count": 2, "bytes": 3e9 + i}
            for i, k in enumerate(hw.COLLECTIVE_MULTIPLIER)}
    assert dryrun.roofline_terms(5e15, 7e11, coll) == \
        ref_roofline_terms(5e15, 7e11, coll)


def test_accum_and_coverage_match_reference():
    assert dryrun.TRAIN_ACCUM == REF_TRAIN_ACCUM
    assert ARCH_IDS == REF_ARCH_IDS
    cells = {a: [c.name for c in cells_for(get_config(a))] for a in ARCH_IDS}
    assert cells == {a: [c.name for c in ref_cells_for(ref_get_config(a))]
                     for a in ARCH_IDS}
    assert sum(map(len, cells.values())) == 32
    assert {k: dataclasses.astuple(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in REF_SHAPES.items()}


def test_hillclimb_matches_reference():
    """The same variants, and each variant's rules the reference's (beside
    the port's own ``core_batch`` rule)."""
    assert hillclimb.VARIANTS == ref_hillclimb.VARIANTS
    for variants in hillclimb.VARIANTS.values():
        for v in variants:
            table = dict(hillclimb.rules_for(v).table)
            assert table.pop("core_batch") == ("pod", "data", "model")
            assert table == dict(ref_hillclimb.rules_for(v).table)


def test_enrich_rewrites_the_analytic_blocks(tmp_path, cached_counts):
    d = tmp_path / "16x16"
    d.mkdir()
    path = d / "glm4-9b__decode_32k.json"
    path.write_text(json.dumps({"arch": "glm4-9b", "shape": "decode_32k",
                                "mesh": "16x16", "accum": 1, "tag": ""}))
    enrich.main(["--dir", str(tmp_path)])
    rec = json.loads(path.read_text())
    cfg, cell = get_config("glm4-9b"), SHAPES["decode_32k"]
    assert rec["analytic"] == json.loads(json.dumps(
        analytics.cell_analytics(cfg, cell, False, 1)))
    assert rec["hbm_capacity"]["budget_gib"] == hw.HBM_BYTES / 2**30


# ---------------- abstract inputs and their placements ----------------


@pytest.fixture
def fake_meshes():
    from torch.distributed.device_mesh import DeviceMesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=512)
    try:
        yield {k: DeviceMesh("cpu", torch.arange(math.prod(shape))
                             .reshape(shape), mesh_dim_names=names)
               for k, (shape, names) in MESHES.items()}
    finally:
        dist.destroy_process_group()


@pytest.fixture
def ref_specs_plain(monkeypatch):
    """The reference's ``input_specs`` with each ``NamedSharding`` its bare
    spec (a duck-typed mesh cannot make one), its abstract inits read
    once an arch."""
    monkeypatch.setattr(ref_specs, "NamedSharding",
                        lambda mesh, spec: tuple(spec))
    monkeypatch.setattr(ref_specs, "init_lm",
                        functools.cache(ref_model.init_lm))
    monkeypatch.setattr(ref_specs, "init_cache",
                        functools.cache(ref_model.init_cache))
    return ref_specs


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


def _ref_param_specs(params, shardings):
    """The reference's ``{port name: (spec, shape)}`` a layer (its stacks'
    leading layer axis dropped from each spec)."""
    out = {}
    for name, (spec, shape) in _per_layer(params, shardings).items():
        if name.split(".")[0] in STACKS:
            assert spec[0] is None
            spec = spec[1:]
        out[name] = (spec, shape)
    return out


_SPEC_CASES = [(a, m) for a in ARCH_IDS for m in MESHES]


@pytest.mark.parametrize("arch,mesh_name", _SPEC_CASES,
                         ids=[f"{a}-{m}" for a, m in _SPEC_CASES])
def test_input_specs_match_reference(arch, mesh_name, fake_meshes,
                                     ref_specs_plain):
    """For each of the arch's cells: the shapes, dtypes and placements of
    every argument of the step equal the reference's."""
    shape, names = MESHES[mesh_name]
    mesh, ref_mesh = fake_meshes[mesh_name], _RefMesh(shape, names)
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    for cell in cells_for(cfg):
        args, sh = specs.input_specs(cfg, cell, Rules(), mesh)
        ref_args, ref_sh = ref_specs_plain.input_specs(
            ref_cfg, REF_SHAPES[cell.name], RefRules(), ref_mesh)
        assert len(args) == len(ref_args)
        # parameters: one spec a layer
        want = _ref_param_specs(ref_args[0], ref_sh[0])
        got = {n: (sh[0][n].spec, tuple(p.shape))
               for n, p in args[0].named_parameters()}
        assert got == want, cell.name
        for a, s in zip(args[0].parameters(), sh[0].values()):
            assert a.device.type == "meta" and s.mesh is mesh
        # the other arguments leaf by leaf
        for i in range(1, len(args)):
            got_leaves = dict(_leaves(args[i]))
            got_specs = dict(_leaves(sh[i]))
            ref_leaves = _ref_leaves(ref_args[i], ref_sh[i], cell.kind, i,
                                     ref_args[0])
            assert set(got_leaves) == set(ref_leaves), (cell.name, i)
            for k, t in got_leaves.items():
                ref_shape, ref_dtype, ref_spec = ref_leaves[k]
                assert tuple(t.shape) == ref_shape, (cell.name, i, k)
                assert str(t.dtype).split(".")[-1] == ref_dtype, \
                    (cell.name, i, k)
                assert got_specs[k].spec == ref_spec, (cell.name, i, k)


def _ref_leaves(tree, shardings, kind, i, ref_params):
    """``{path: (shape, dtype, spec)}`` of one of the reference's step
    arguments, named as the port's: the optimizer moments a layer each
    (as the parameters), every other leaf as it is."""
    import jax
    if kind == "train" and i == 1:
        out = {}
        for moment in ("m", "v"):
            per = _ref_param_specs(tree[moment], shardings[moment])
            for name, (spec, shape) in per.items():
                out[(moment, name)] = (shape, _leaf_dtype(tree[moment], name),
                                       spec)
        out[("count",)] = ((), "int32", tuple(shardings["count"]))
        return out
    if not isinstance(tree, dict):
        return {(): (tuple(tree.shape), str(tree.dtype), tuple(shardings))}
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    out = {}
    for path, leaf in flat:
        key = tuple(p.key for p in path)
        node = shardings
        for k in key:
            node = node[k]
        out[key] = (tuple(leaf.shape), str(leaf.dtype), tuple(node))
    return out


def _leaf_dtype(tree, name):
    """The dtype of the reference's leaf behind a port parameter name."""
    keys = name.split(".")
    node = tree
    for k in keys:
        if k.isdigit():
            continue
        node = node[k]
    return str(node.dtype)


# ---------------- the dry run ----------------

_DRY_ARCHS = ("glm4-9b", "granite-moe-1b-a400m", "zamba2-1.2b")
_DRY_CELLS = {k: ShapeCell(f"smoke_{k}", k, 16, 8)
              for k in ("train", "prefill", "decode")}
_DRY = [(a, k) for a in _DRY_ARCHS for k in _DRY_CELLS]


@pytest.fixture
def smoke_configs(monkeypatch):
    """The dry run's ``get_config`` gives each arch's smoke config."""
    monkeypatch.setattr(dryrun, "get_config", get_smoke_config)


def _unsharded_flops(arch, kind, accum):
    """``FlopCounterMode`` over the same step on plain CPU tensors."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.models.model import init_cache, init_lm
    from repro_torch.optim import init_opt_state
    cfg, cell = get_smoke_config(arch), _DRY_CELLS[kind]
    step = dryrun.build_step(cfg, cell, Rules(), accum)
    lm = init_lm(cfg, seed=0, device="cpu")
    b, s = cell.global_batch, cell.seq_len
    tokens = torch.randint(0, cfg.vocab_size, (b, s), dtype=torch.int32)
    with FlopCounterMode(display=False) as fc:
        if kind == "train":
            step(lm, init_opt_state(lm), {"tokens": tokens,
                                          "labels": tokens}, 0)
        elif kind == "prefill":
            with torch.no_grad():
                step(lm, {"tokens": tokens})
        else:
            cache, _ = init_cache(cfg, b, s, device="cpu")
            with torch.no_grad():
                step(lm, cache, tokens[:, :1], torch.tensor(0))
    return fc.get_total_flops()


@pytest.mark.parametrize("arch,kind", _DRY, ids=[f"{a}-{k}" for a, k in _DRY])
def test_dry_run_on_a_fake_4x2_group(arch, kind, smoke_configs):
    accum = 2 if kind == "train" and arch == "granite-moe-1b-a400m" else 1
    rec = dryrun.run_cell(arch, _DRY_CELLS[kind], False, accum=accum,
                          mesh_shape=(4, 2))
    assert not dist.is_initialized()
    unsharded = _unsharded_flops(arch, kind, accum)
    n = rec["devices"]
    assert (n, rec["mesh"], rec["sort_impl"]) == (8, "4x2", "xla")
    # the global count is the unsharded step's; rank 0 computes its share
    # and the redundant work the record states, and less than the whole
    assert rec["flops_global"] == unsharded
    assert rec["flops_per_device"] * n == unsharded + rec["flops_redundant"]
    assert rec["flops_redundant"] >= 0
    assert sum(rec["flops_redundant_by_op"].values()) == \
        rec["flops_redundant"]
    assert 0 < rec["flops_per_device"] < unsharded
    # the FSDP x TP plan: parameters gathered, gradients reduce-scattered
    kinds = set(rec["collectives"])
    assert kinds <= set(hw.COLLECTIVE_MULTIPLIER)
    assert "all-gather" in kinds
    if kind == "train":
        assert "reduce-scatter" in kinds
    assert all(v["count"] > 0 and v["bytes"] > 0
               for v in rec["collectives"].values())
    mem = rec["memory"]
    total_p, _ = specs.count_params(get_smoke_config(arch))
    assert 0 < mem["params_bytes"] < 4 * total_p
    assert mem["peak_bytes"] >= mem["resident_bytes"] > 0
    assert (mem["opt_state_bytes"] > 0) == (kind == "train")
    assert (mem["cache_bytes"] > 0) == (kind == "decode")
    assert rec["hbm_bytes_per_device"] > 0
    assert set(rec["roofline"]) == {"compute_s", "memory_s",
                                    "collective_s", "bottleneck"}
    # the fake group is gone: a real one can be made right after
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    dist.destroy_process_group()


@pytest.mark.parametrize("kind", sorted(_DRY_CELLS))
def test_dry_run_on_one_rank_has_no_collectives(kind, smoke_configs):
    arch = "granite-moe-1b-a400m"
    rec = dryrun.run_cell(arch, _DRY_CELLS[kind], False, accum=1,
                          mesh_shape=(1, 1))
    assert rec["collectives"] == {}
    assert rec["flops_redundant"] == 0
    assert rec["flops_per_device"] == rec["flops_global"] == \
        _unsharded_flops(arch, kind, 1)
    total_p, _ = specs.count_params(get_smoke_config(arch))
    assert rec["memory"]["params_bytes"] == 4 * total_p


@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_dry_run_with_heads_that_do_not_divide_model(kind, smoke_configs):
    """2 KV heads on a 4-way ``model`` axis (8 on the production mesh's
    16): the projections' fused (heads, k) axis and the queries' split into
    (kv heads, group) must stay placeable, forward and backward."""
    rec = dryrun.run_cell("glm4-9b", _DRY_CELLS[kind], False, accum=1,
                          mesh_shape=(2, 4))
    assert rec["flops_global"] == _unsharded_flops("glm4-9b", kind, 1)


def test_artifacts_and_their_table(tmp_path, smoke_configs):
    rec = dryrun.run_cell("glm4-9b", _DRY_CELLS["decode"], False,
                          mesh_shape=(2, 1))
    path = dryrun.artifact_path(rec, str(tmp_path))
    assert path.endswith("2x1/glm4-9b__smoke_decode.json")
    with open(path, "w") as f:
        json.dump(rec, f)
    rows = dryrun.table(str(tmp_path)).splitlines()
    assert len(rows) == 3 and rows[2].startswith(
        "| glm4-9b | smoke_decode | 2x1 |")


# the hillclimb's cells at the smoke configs: small batches and short
# sequences, but every variant's accumulation, and a prefill long enough
# (4,096 > the chunked variant's 2,048) to take the streaming attention
_HC_SHAPES = {"train_4k": ShapeCell("train_4k", "train", 64, 64),
              "decode_32k": ShapeCell("decode_32k", "decode", 64, 16),
              "prefill_32k": ShapeCell("prefill_32k", "prefill", 4096, 2)}


@pytest.mark.parametrize("cell_key", sorted(hillclimb.VARIANTS))
def test_hillclimb_traces_every_variant(cell_key, tmp_path, smoke_configs,
                                        monkeypatch):
    """``hillclimb.main`` on the production 16 x 16 fake group: every
    variant that is not analytic-only traces (SP's ``res_seq``, the
    weights-resident rules, the chunked attention), and the traced records
    show each variant's lever."""
    monkeypatch.setattr(dryrun, "SHAPES", _HC_SHAPES)
    hillclimb.main(["--only", cell_key, "--out", str(tmp_path)])
    arch, shape = cell_key.split("/")
    recs = {}
    for v in hillclimb.VARIANTS[cell_key]:
        with open(tmp_path / f"{arch}__{shape}__{v['tag']}.json") as f:
            rec = json.load(f)
        assert rec["variant"] == v and rec["accum"] == v["accum"]
        assert "analytic" in rec and "hbm_capacity" in rec
        if v.get("analytic_only"):
            assert "flops_per_device" not in rec
            continue
        assert (rec["mesh"], rec["devices"], rec["tag"]) == \
            ("16x16", 256, v["tag"])
        assert rec["flops_per_device"] > 0
        assert rec.get("cfg_overrides") == v.get("cfg_overrides")
        recs[v["tag"]] = rec["memory"]
    base = recs["baseline"]
    if "resident" in recs:          # parameters split over `model` only
        assert recs["resident"]["params_bytes"] > base["params_bytes"]
    if "chunked_attn" in recs:      # no (T, S) score buffer
        assert recs["chunked_attn"]["peak_bytes"] < base["peak_bytes"]
    if "sp_accum32" in recs:        # saved residuals split over `model`
        assert recs["sp_accum32"]["peak_bytes"] < base["peak_bytes"]


def test_dry_run_refuses_a_live_group():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        with pytest.raises(RuntimeError, match="exists already"):
            dryrun.run_cell("glm4-9b", "decode_32k", False)
    finally:
        dist.destroy_process_group()


# ---------------- C8: the engine serves a sharded LM ----------------

_C8_SCRIPT = r"""
import copy, json
import numpy as np
from repro_torch.configs import get_smoke_config
from repro_torch.models.model import init_lm
from repro_torch.models.param import shard_lm
from repro_torch.parallel.compat import make_mesh
from repro_torch.parallel.sharding import Rules
from repro_torch.serve import engine as E
cfg = get_smoke_config("granite-moe-1b-a400m").replace(
    param_dtype="float32", compute_dtype="float32")
lm = init_lm(cfg, seed=0, device="cpu")
rng = np.random.default_rng(0)
prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist()
           for n in (5, 9, 3, 7, 12, 4, 6, 8)]
want = E.Engine(cfg, copy.deepcopy(lm), max_seq=32).generate(prompts, 4)
shard_lm(lm, Rules(), make_mesh((1, 2), ("data", "model"), "cpu"))
modes = []
forward, decode = E.forward, E.decode_step
def seen(fn):
    def run(*a, **k):
        modes.append(torch.is_inference_mode_enabled())
        return fn(*a, **k)
    return run
import torch
E.forward, E.decode_step = seen(forward), seen(decode)
eng = E.Engine(cfg, lm, max_seq=32)
got = eng.generate(prompts, 4)
sharded = type(lm.embed).__name__
with open(f"{workdir}/c8_{rank}.json", "w") as f:
    json.dump({"want": want, "got": got, "modes": modes,
               "param_type": sharded}, f)
"""


@pytest.fixture(scope="module")
def c8_ranks(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("c8")
    _torch_mesh.launch_ranks(_C8_SCRIPT, 2, workdir, timeout=240)
    return [json.loads((workdir / f"c8_{r}.json").read_text())
            for r in range(2)]


@pytest.mark.parametrize("rank", [0, 1])
def test_sharded_engine_tokens_equal_unsharded(rank, c8_ranks):
    out = c8_ranks[rank]
    assert out["param_type"] == "DTensor"
    assert out["got"] == out["want"]


@pytest.mark.parametrize("rank", [0, 1])
def test_sharded_engine_is_not_under_inference_mode(rank, c8_ranks):
    modes = c8_ranks[rank]["modes"]
    assert len(modes) == 4 and not any(modes)


def test_unsharded_engine_keeps_inference_mode():
    from repro_torch.models.model import init_lm
    from repro_torch.serve import engine as E
    cfg = get_smoke_config("glm4-9b")
    eng = E.Engine(cfg, init_lm(cfg, seed=0, device="cpu"), max_seq=16)
    seen = []
    real = E.forward

    def spy(*a, **k):
        seen.append(torch.is_inference_mode_enabled())
        return real(*a, **k)
    E.forward = spy
    try:
        eng.generate([[1, 2, 3]], 2)
    finally:
        E.forward = real
    assert seen == [True] and eng.mesh is None
