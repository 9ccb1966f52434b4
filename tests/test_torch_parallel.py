"""The port's parallel plan against the reference's, in one process: the
logical axes of every parameter (``finalize``) and the specs of every
parameter and cache leaf (``spec``, ``mesh_spec``, ``shape_spec``,
``spec_for``, ``tree_specs``) of all ten archs' published configs on four
meshes; ``Builder.param``'s check of its axes; the int8 compression's bits;
the placements a spec renders to; and the mesh factories. The meshes are
``DeviceMesh``es over a fake process group of 512 ranks (no process is
started), so a pod's mesh can be built here."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import get_config as ref_get_config
from repro.models.model import init_cache as ref_init_cache
from repro.models.model import init_lm as ref_init_lm
from repro.models.param import tree_specs as ref_tree_specs
from repro.parallel import compression as ref_comp
from repro.parallel.sharding import Rules as RefRules
from repro.parallel.sharding import spec_for as ref_spec_for
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.interop import to_numpy
from repro_torch.models.model import init_cache, init_lm
from repro_torch.models.param import Builder, finalize, tree_specs
from repro_torch.parallel import compression as comp
from repro_torch.parallel.sharding import Rules, placements, spec_for

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "pod": ((2, 16, 16), ("pod", "data", "model")),
          "4x2": ((4, 2), ("data", "model")),
          "8x1": ((8, 1), ("data", "model"))}
STACKS = ("first", "blocks")
CACHE_B, CACHE_S = 8, 4096


class _RefMesh:
    """What the reference's spec helpers read of a mesh: its axis names
    and sizes."""

    def __init__(self, shape, names):
        self.axis_names = names
        self.shape = dict(zip(names, shape))


@pytest.fixture
def meshes():
    """Every mesh of ``MESHES`` as a ``DeviceMesh`` over a fake process
    group of 512 ranks, for one test (a process has one default group)."""
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


@pytest.fixture(scope="module")
def trees():
    """Per arch: the reference's abstract params and axes, and the port's
    axes from its ``LM`` on ``meta``."""
    out = {}
    for arch in ARCH_IDS:
        params, axes = ref_init_lm(ref_get_config(arch), abstract=True)
        out[arch] = (params, axes, init_lm(get_config(arch), device="meta"))
    return out


def _per_layer(params, tree):
    """``{port name: (leaf of tree, shape)}`` for each leaf of the
    reference's ``params``: ``tree`` (its axes or specs, the same
    structure) read at the leaf's path, a stacked leaf one entry a layer
    with the shape of a layer."""
    named = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        keys = [p.key for p in path]
        node = tree
        for k in keys:
            node = node[k]
        if keys[0] in STACKS:
            for i in range(leaf.shape[0]):
                named[".".join([keys[0], str(i)] + keys[1:])] = \
                    (tuple(node), tuple(leaf.shape[1:]))
        else:
            named[".".join(keys)] = (tuple(node), tuple(leaf.shape))
    return named


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_finalize_matches_reference(arch, trees):
    params, axes, lm = trees[arch]
    ref = _per_layer(params, axes)
    got = finalize(lm)
    assert got.keys() == ref.keys()
    for name, p in lm.named_parameters():
        assert ref[name][0][0] == "layers" or name.split(".")[0] not in \
            STACKS
        want = ref[name][0][1:] if name.split(".")[0] in STACKS \
            else ref[name][0]
        assert got[name] == want, name
        assert tuple(p.shape) == ref[name][1], name


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_reference(arch, mesh_name, trees, meshes):
    """``spec``, ``mesh_spec``, ``shape_spec`` (through ``tree_specs``)
    and ``spec_for`` of every parameter, entry for entry."""
    params, axes, lm = trees[arch]
    shape, names = MESHES[mesh_name]
    ref_mesh, mesh = _RefMesh(shape, names), meshes[mesh_name]
    rules, ref_rules = Rules(), RefRules()
    ref_named = _per_layer(params, ref_tree_specs(axes, ref_rules, ref_mesh,
                                                  params))
    got_shape = tree_specs(finalize(lm), rules, mesh, lm)
    got_mesh = tree_specs(finalize(lm), rules, mesh)
    for name, ax in finalize(lm).items():
        ref_entry = ref_named[name][0]
        if name.split(".")[0] in STACKS:
            assert ref_entry[0] is None            # the layer axis
            ref_entry = ref_entry[1:]
        assert got_shape[name] == ref_entry, name
        assert got_mesh[name] == tuple(ref_rules.mesh_spec(ax, names)), name
        assert rules.spec(ax) == tuple(ref_rules.spec(ax)), name
        assert spec_for(rules, ax, mesh) == tuple(
            ref_spec_for(ref_rules, ax, ref_mesh)), name


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_match_reference(arch, mesh_name, meshes):
    shape, names = MESHES[mesh_name]
    ref_cache, ref_axes = ref_init_cache(ref_get_config(arch), CACHE_B,
                                         CACHE_S, abstract=True)
    cache, axes = init_cache(get_config(arch), CACHE_B, CACHE_S,
                             abstract=True)
    assert axes == jax.tree.map(tuple, ref_axes,
                                is_leaf=lambda x: isinstance(x, tuple))
    ref = ref_tree_specs(ref_axes, RefRules(), _RefMesh(shape, names),
                         ref_cache)
    got = tree_specs(axes, Rules(), meshes[mesh_name], cache)
    for stack, leaves in got.items():
        for k, spec in leaves.items():
            assert spec == tuple(ref[stack][k]), (stack, k)
            assert tuple(cache[stack][k].shape) == \
                tuple(ref_cache[stack][k].shape)


def test_shape_spec_cases():
    """The reference's own cases (``tests/test_parallel.py``)."""
    r, sizes = Rules(), {"data": 16, "model": 16, "pod": 2}
    assert r.shape_spec(("embed", "kv_heads", None), (1024, 8, 64),
                        sizes) == ("data", None, None)
    assert r.shape_spec(("embed", "heads", None), (1024, 32, 64),
                        sizes) == ("data", "model", None)
    assert r.shape_spec(("batch", "seq"), (8, 128), sizes)[0] == "pod"
    assert r.shape_spec(("batch", "seq"), (64, 128), sizes)[0] == \
        ("pod", "data")
    assert r.mesh_spec(("batch", "seq", "act_heads"), ("data",)) == \
        ("data", None, None)
    # sequence parallelism: `model` goes to the first logical axis only
    sp = r.override(res_seq="model")
    assert sp.shape_spec(("batch", "res_seq", "act_heads"), (8, 64, 16),
                         sizes) == ("pod", "model", None)


def test_placements(meshes):
    from torch.distributed.tensor import Replicate, Shard
    mesh = meshes["pod"]
    assert placements(("pod", None), mesh) == (Shard(0), Replicate(),
                                               Replicate())
    assert placements((("pod", "data"), "model"), mesh) == (
        Shard(0), Shard(0), Shard(1))
    assert placements((None, None), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="mesh's order"):
        placements((("data", "pod"),), mesh)


def test_builder_param_checks_axes():
    b = Builder(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="do not match"):
        b.param((4, 8), ("embed",))
    p = b.param((4, 8), ("embed", "mlp"))
    assert p.axes == ("embed", "mlp")
    assert b.param((3,)).axes == (None,)


def _floats(seed, n=257):
    rng = np.random.default_rng(seed)
    x = rng.normal(scale=3.0, size=n).astype(np.float32)
    x[::17] = 0.0
    x[5] = -x[:].__abs__().max() * 1.5          # the extreme value
    x[7] = np.float32(0.5) * x[5] / 127.0 * 2   # an exact half step
    return x


@pytest.mark.parametrize("seed", range(4))
def test_quantize_bits_match_reference(seed):
    x = _floats(seed)
    q, s = comp.quantize_int8(torch.from_numpy(x))
    rq, rs = ref_comp.quantize_int8(jnp.asarray(x))
    np.testing.assert_array_equal(to_numpy(q), np.asarray(rq))
    assert to_numpy(s).tobytes() == np.asarray(rs).tobytes()
    d = comp.dequantize_int8(q, s)
    rd = ref_comp.dequantize_int8(rq, rs)
    assert to_numpy(d).tobytes() == np.asarray(rd).tobytes()


def test_ef_compress_bits_match_reference():
    """Ten steps of error feedback on a two-leaf tree, bit for bit."""
    rng = np.random.default_rng(0)
    g = {"w": rng.normal(size=(32, 8)).astype(np.float32),
         "b": {"c": rng.normal(size=(5,)).astype(np.float32)}}
    res = comp.ef_init({k: torch.from_numpy(v) if not isinstance(v, dict)
                        else {"c": torch.from_numpy(v["c"])}
                        for k, v in g.items()})
    ref_res = ref_comp.ef_init(jax.tree.map(jnp.asarray, g))
    for step in range(10):
        gs = jax.tree.map(lambda a: a * (1 + step), g)
        tg = {"w": torch.from_numpy(gs["w"]),
              "b": {"c": torch.from_numpy(gs["b"]["c"])}}
        (c, res), (rc, ref_res) = (comp.ef_compress(tg, res),
                                   ref_comp.ef_compress(
                                       jax.tree.map(jnp.asarray, gs),
                                       ref_res))
        for got, want in ((c["w"], rc["w"]), (c["b"]["c"], rc["b"]["c"])):
            np.testing.assert_array_equal(to_numpy(got[0]),
                                          np.asarray(want[0]))
            assert to_numpy(got[1]).tobytes() == np.asarray(want[1]).tobytes()
        assert to_numpy(res["w"]).tobytes() == \
            np.asarray(ref_res["w"]).tobytes()
        assert to_numpy(res["b"]["c"]).tobytes() == \
            np.asarray(ref_res["b"]["c"]).tobytes()


def test_mesh_factories(tmp_path):
    """``test_launch.py::test_mesh_factories`` on a one-rank group, and the
    production mesh's refusal to build on it."""
    from repro_torch.launch.mesh import (make_elastic_mesh,
                                         make_production_mesh,
                                         make_test_mesh)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            rank=0, world_size=1)
    try:
        m = make_test_mesh(device_type="cpu")
        assert set(m.mesh_dim_names) == {"data", "model"}
        e = make_elastic_mesh(1, model_parallel=4, device_type="cpu")
        assert e.size() == 1
        with pytest.raises(RuntimeError, match="needs 256 ranks"):
            make_production_mesh(device_type="cpu")
        with pytest.raises(RuntimeError, match="needs 512 ranks"):
            make_production_mesh(multi_pod=True, device_type="cpu")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_recompute_sees_the_forward_mesh_on_another_thread(remat):
    """A checkpointed block recomputes under the mesh of its forward even
    where the backward pass runs on another thread (autograd's own thread
    for CUDA tensors), which does not see the caller's ``set_mesh``."""
    import threading

    from repro_torch.models.model import _maybe_remat
    from repro_torch.parallel.compat import get_mesh, set_mesh
    seen, mesh = [], object()

    def block(x):
        seen.append(get_mesh())
        return torch.tanh(x @ x.T)

    x = torch.randn(4, 4, requires_grad=True)
    with set_mesh(mesh):
        y = _maybe_remat(block, remat)(x).sum()
    grads = []
    worker = threading.Thread(
        target=lambda: grads.append(torch.autograd.grad(y, x)[0]))
    worker.start()
    worker.join(timeout=60)
    assert not worker.is_alive() and len(grads) == 1
    assert seen == [mesh, mesh] and get_mesh() is None
