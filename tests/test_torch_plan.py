"""The parallel plan run sharded: one launch of 8 gloo ranks over the
reference's ``(data 4, model 2)`` mesh (``tests/_torch_mesh.py``'s
pattern), and one reference subprocess on 8 fake XLA devices, both from
the same numpy weights and inputs (``tests/_torch_plan.py``); each writes
an ``.npz`` that the parametrised cases read.

Held: the sharded forward of four smoke archs and the decode steps of two
against the reference's sharded run and the port's unsharded run (2e-3,
the reference's bound in ``tests/test_distributed_model.py``); Granite's
sharded train step under each remat mode against the unsharded step
(loss 1e-5 relative, grad norm 1e-4 relative, each parameter's change
from the initial weights within 5e-5 and the moments within 1e-3 of each
leaf's largest, the training tests' bounds), 'pallas' equal to 'xla' bit
for bit;
``ep_moe`` against the port's ``moe`` and the reference's ``ep_moe``
(2e-4); the ring collectives, the pipeline and ``compressed_psum`` (the
reference's bits); the compressed data-parallel training loop of
``tests/test_compression_training.py``; and a sharded snapshot written
as an unsharded one's bytes and restored bit for bit into the unsharded
LM and onto another mesh shape, right after the save, and by every rank
at the step rank 0's asynchronous writer is still writing."""

import threading

import numpy as np
import pytest

import _torch_plan as tp
from _torch_mesh import launch_ranks, run_reference

FWD_ATOL = 2e-3
EP_ATOL = 2e-4

_REF_SCRIPT = r"""
import sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
import _torch_plan as tp
from repro.configs import get_smoke_config
from repro.models.model import decode_step, forward, init_cache, init_lm
from repro.models.moe_ep import ep_moe
from repro.models.param import tree_specs
from repro.parallel.compat import AxisType, make_mesh, set_mesh, shard_map
from repro.parallel.compression import compressed_psum
from repro.parallel.sharding import Rules

rules = Rules()
mesh = make_mesh(*tp.MESH, axis_types=(AxisType.Auto,) * 2)
is_p = lambda x: isinstance(x, P)


def place(tree, axes):
    specs = tree_specs(axes, rules, mesh, tree)
    return jax.tree.map(lambda a, s: jax.device_put(a, NamedSharding(mesh, s)),
                        tree, specs, is_leaf=is_p)


out = {}
for arch in tp.FORWARD_ARCHS:
    cfg = get_smoke_config(arch)
    _, axes = init_lm(cfg, abstract=True)
    params = place(jax.tree.map(jnp.asarray, tp.weights(arch)), axes)
    tokens = jnp.asarray(tp.batch(cfg)["tokens"])
    with set_mesh(mesh):
        fwd = jax.jit(lambda p, t: forward(cfg, p, {"tokens": t}, rules)[0])
        out[f"{arch}/forward"] = np.asarray(fwd(params, tokens))
        if arch in tp.DECODE_ARCHS:
            cache, c_axes = init_cache(cfg, tp.B, tp.S)
            cache = place(cache, c_axes)
            dec = jax.jit(lambda p, c, t, i: decode_step(cfg, p, c, t, i,
                                                         rules))
            for i in range(tp.DECODE_STEPS):
                lg, cache = dec(params, cache, tokens[:, i:i + 1],
                                jnp.int32(i))
                out[f"{arch}/decode{i}"] = np.asarray(lg)

cfg = tp.ep_config()
e = {k: jnp.asarray(v) for k, v in tp.ep_inputs().items()}
ep_mesh = make_mesh((8,), ("ep",), axis_types=(AxisType.Auto,))
y, aux = ep_moe(cfg, ep_mesh, "ep", e["x"], e["router"], e["w_in"], e["w_out"])
out["ep/y"], out["ep/aux"] = np.asarray(y), np.asarray(aux)

y = jnp.asarray(tp.collective_inputs()["y"])
h = jax.jit(shard_map(lambda v, r: compressed_psum(v, "ep", r), mesh=ep_mesh,
                      in_specs=(P("ep"), P("ep")),
                      out_specs=(P("ep"), P("ep"))))
m, r = h(y, jnp.zeros_like(y))
out["cpsum/mean"], out["cpsum/residual"] = np.asarray(m), np.asarray(r)
np.savez(sys.argv[1], **out)
"""

_RANK_SCRIPT = r"""
import contextlib, copy, types
import numpy as np
import _torch_plan as tp
from repro_torch import checkpoint
from repro_torch.configs import get_smoke_config
from repro_torch.interop import lm_from_reference, to_numpy
from repro_torch.models.model import decode_step, forward, init_cache
from repro_torch.models.moe import moe
from repro_torch.models.moe_ep import ep_moe
from repro_torch.models.param import (distribute_tree, finalize, shard_lm,
                                      tree_specs)
from repro_torch.optim import init_opt_state
from repro_torch.parallel import compat
from repro_torch.parallel.compat import all_gather, make_mesh, psum, set_mesh
from repro_torch.parallel.compression import compressed_psum
from repro_torch.parallel.pipeline import pipeline_forward
from repro_torch.parallel.ring import ring_all_gather, ring_all_reduce
from repro_torch.parallel.sharding import NamedSharding, Rules
from repro_torch.training.steps import Hyper, make_train_step

rules = Rules()
mesh = make_mesh(*tp.MESH, device_type="cpu")
out = {}
full = to_numpy            # a DTensor's global array; every rank calls it


def lm_of(arch):
    return lm_from_reference(get_smoke_config(arch), tp.weights(arch),
                             device="cpu")


# ---- forward and decode, unsharded and sharded ----
for arch in tp.FORWARD_ARCHS:
    cfg = get_smoke_config(arch)
    lm = lm_of(arch)
    lm_s = shard_lm(copy.deepcopy(lm), rules, mesh)
    tokens = torch.from_numpy(tp.batch(cfg)["tokens"])
    with torch.no_grad():
        out[f"{arch}/forward/single"] = full(
            forward(cfg, lm, {"tokens": tokens}, rules)[0])
        with set_mesh(mesh):
            out[f"{arch}/forward/sharded"] = full(
                forward(cfg, lm_s, {"tokens": tokens}, rules)[0])
        if arch in tp.DECODE_ARCHS:
            cache, axes = init_cache(cfg, tp.B, tp.S, device="cpu")
            cache_s = distribute_tree(
                init_cache(cfg, tp.B, tp.S, device="cpu")[0], axes, rules,
                mesh)
            for i in range(tp.DECODE_STEPS):
                t = tokens[:, i:i + 1]
                out[f"{arch}/decode{i}/single"] = full(
                    decode_step(cfg, lm, cache, t, i, rules)[0])
                with set_mesh(mesh):
                    out[f"{arch}/decode{i}/sharded"] = full(
                        decode_step(cfg, lm_s, cache_s, t, i, rules)[0])

# ---- one train step, unsharded and sharded under each remat mode ----
cfg = get_smoke_config(tp.TRAIN_ARCH)
lm = lm_of(tp.TRAIN_ARCH)
batch = {k: torch.from_numpy(v) for k, v in tp.batch(cfg).items()}


def step_of(remat, impl, sharded, key):
    step = make_train_step(cfg.replace(remat=remat), rules,
                           Hyper(**tp.HYPER, sort_impl=impl))
    l = copy.deepcopy(lm)
    if sharded:
        l = shard_lm(l, rules, mesh)
    opt = init_opt_state(l)
    with set_mesh(mesh) if sharded else contextlib.nullcontext():
        l, opt, m = step(l, opt, batch, 1)
    out[f"{key}/loss"] = full(m["loss"])
    out[f"{key}/grad_norm"] = full(m["grad_norm"])
    out[f"{key}/lr"] = full(m["lr"])
    for k, v in l.named_parameters():
        out[f"{key}/param/{k}"] = full(v)
        for mom in ("m", "v"):
            out[f"{key}/{mom}/{k}"] = full(opt[mom][k])


for k, v in lm.named_parameters():
    out[f"train/init/{k}"] = full(v)
step_of("none", "xla", False, "train/single")
for remat in tp.REMATS:
    for impl in ("xla", "pallas"):
        step_of(remat, impl, True, f"train/{remat}/{impl}")

# ---- expert parallelism over 8 ranks ----
ep_mesh = make_mesh((8,), ("ep",), device_type="cpu")
group, me = ep_mesh.get_group("ep"), dist.get_rank()
cfg = tp.ep_config()
e = {k: torch.from_numpy(v) for k, v in tp.ep_inputs().items()}
y, aux = ep_moe(cfg, ep_mesh, "ep", e["x"], e["router"], e["w_in"],
                e["w_out"])
out["ep/y"], out["ep/aux"] = full(y), full(aux)
p = types.SimpleNamespace(router=e["router"], w_in=e["w_in"],
                          w_out=e["w_out"])
with torch.no_grad():
    ym, auxm = moe(cfg, p, e["x"][None], rules)
out["ep/moe"], out["ep/moe_aux"] = full(ym[0]), full(auxm)

# ---- the ring, the pipeline and the compressed sum ----
c = {k: torch.from_numpy(v) for k, v in tp.collective_inputs().items()}
y = c["y"][me:me + 1]
out["ring/reduce"] = full(all_gather(ring_all_reduce(y, group), group))
out["ring/gather"] = full(all_gather(ring_all_gather(c["y"][me], group),
                                     group))
pf = pipeline_forward(lambda w, x: torch.tanh(x @ w), c["ws"][me], c["mbs"],
                      group)
out["pipeline"] = full(all_gather(pf, group))
out["staged_ag"] = full(compat._all_gather_into_tensor(y, 8,
                                                      group.group_name))
mean, res = compressed_psum(y, group, torch.zeros_like(y))
out["cpsum/mean"] = full(all_gather(mean, group).reshape(8, -1))
out["cpsum/residual"] = full(all_gather(res, group).reshape(8, -1))

# ---- compressed data-parallel training (test_compression_training) ----
rng = np.random.default_rng(0)
D, H, STEPS, B_LOC = 16, 32, 200, 8
w_true = (rng.normal(size=(D,)) * 0.3).astype(np.float32)
X = rng.normal(size=(STEPS, 8, B_LOC, D)).astype(np.float32)
Y = (X @ w_true + 0.01 * rng.normal(size=(STEPS, 8, B_LOC))).astype(
    np.float32)
p0 = {"w1": (rng.normal(size=(D, H)) * 0.3).astype(np.float32),
      "w2": (rng.normal(size=(H, 1)) * 0.3).astype(np.float32)}


def train(compressed):
    p = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    res = {k: torch.zeros_like(v) for k, v in p.items()}
    losses = []
    for s in range(STEPS):
        x, yv = torch.from_numpy(X[s, me]), torch.from_numpy(Y[s, me])
        w = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        loss = torch.mean(((torch.tanh(x @ w["w1"]) @ w["w2"])[..., 0]
                           - yv) ** 2)
        grads = dict(zip(w, torch.autograd.grad(loss, list(w.values()))))
        for k, g in grads.items():
            if compressed:
                grads[k], res[k] = compressed_psum(g, group, res[k])
            else:
                grads[k] = psum(g, group) / 8
        p = {k: p[k] - 0.02 * grads[k] for k in p}
        losses.append(float(psum(loss.detach(), group)) / 8)
    return np.array(losses, np.float32)


out["dp/plain"], out["dp/compressed"] = train(False), train(True)

# ---- a sharded snapshot: its bytes, and restores ----
lm_s = shard_lm(copy.deepcopy(lm), rules, mesh)
snap, plain = workdir + "/snap_sharded", workdir + "/snap_plain"
# no barrier of the caller's: a sharded save returns once it is in place
checkpoint.save(snap, 3, {"params": dict(lm_s.named_parameters())})
target = {"params": dict(lm.named_parameters())}
back = checkpoint.restore(snap, 3, target, device="cpu")["params"]
out["snapshot/plain"] = np.array(all(
    full(back[k]).tobytes() == full(v).tobytes()
    for k, v in lm.named_parameters()))
mesh2 = make_mesh(*tp.RESHARD_MESH, device_type="cpu")
specs = tree_specs(finalize(lm), rules, mesh2, lm)
shard = {"params": {k: NamedSharding(mesh2, s) for k, s in specs.items()}}
back = checkpoint.restore(snap, 3, target, shardings=shard)["params"]
out["snapshot/mesh"] = np.array(all(
    back[k].placements == shard["params"][k].placements
    and back[k].device_mesh is mesh2
    and full(back[k]).tobytes() == full(v).tobytes()
    for k, v in lm.named_parameters()))
if me == 0:
    checkpoint.save(plain, 3, {"params": dict(lm.named_parameters())})

# rank 0 writes step 5 on its writer thread while the others go straight
# on to restore_latest: every rank must restore step 5, bit for bit
mgr = checkpoint.CheckpointManager(workdir + "/managed", keep=2,
                                   async_save=True)
neg = shard_lm(copy.deepcopy(lm), rules, mesh)
with torch.no_grad():
    for v in neg.parameters():
        v.neg_()
mgr.save(3, {"params": dict(neg.named_parameters())})
mgr.save(5, {"params": dict(lm_s.named_parameters())})
got_step, back = mgr.restore_latest(target, shardings=shard)
ok = got_step == 5 and all(
    full(back["params"][k]).tobytes() == full(v).tobytes()
    for k, v in lm.named_parameters())
flag = torch.tensor([float(ok)])
dist.all_reduce(flag, op=dist.ReduceOp.MIN)
out["snapshot/async"] = np.array(bool(flag.item()))

if me == 0:
    np.savez(workdir + "/port.npz", **out)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``(port, reference, workdir)``: the 8 ranks' and the reference's
    arrays, and the directory of the ranks' snapshots."""
    work = tmp_path_factory.mktemp("plan")
    ref_path = work / "ref.npz"
    err = []

    def reference():
        try:
            run_reference(_REF_SCRIPT, [ref_path], timeout=400)
        except BaseException as e:              # noqa: BLE001 - re-raised
            err.append(e)

    th = threading.Thread(target=reference)
    th.start()
    try:
        launch_ranks(_RANK_SCRIPT, 8, work, timeout=400)
    finally:
        th.join()
    if err:
        raise err[0]
    return np.load(work / "port.npz"), np.load(ref_path), work


@pytest.mark.parametrize("arch", tp.FORWARD_ARCHS)
def test_sharded_forward(runs, arch):
    port, ref, _ = runs
    got = port[f"{arch}/forward/sharded"]
    np.testing.assert_allclose(got, port[f"{arch}/forward/single"], rtol=0,
                               atol=FWD_ATOL)
    np.testing.assert_allclose(got, ref[f"{arch}/forward"], rtol=0,
                               atol=FWD_ATOL)


@pytest.mark.parametrize("step", range(tp.DECODE_STEPS))
@pytest.mark.parametrize("arch", tp.DECODE_ARCHS)
def test_sharded_decode(runs, arch, step):
    port, ref, _ = runs
    got = port[f"{arch}/decode{step}/sharded"]
    np.testing.assert_allclose(got, port[f"{arch}/decode{step}/single"],
                               rtol=0, atol=FWD_ATOL)
    np.testing.assert_allclose(got, ref[f"{arch}/decode{step}"], rtol=0,
                               atol=FWD_ATOL)


def _train(port, key):
    return {k[len(key) + 1:]: port[k] for k in port.files
            if k.startswith(key + "/")}


@pytest.mark.parametrize("remat", tp.REMATS)
def test_sharded_train_step(runs, remat):
    port, _, _ = runs
    tp.assert_step_matches(_train(port, "train/init"),
                           _train(port, "train/single"),
                           _train(port, f"train/{remat}/xla"))


@pytest.mark.parametrize("remat", tp.REMATS)
def test_sharded_train_step_pallas_equals_xla(runs, remat):
    port, _, _ = runs
    xla = _train(port, f"train/{remat}/xla")
    pallas = _train(port, f"train/{remat}/pallas")
    assert xla.keys() == pallas.keys()
    for k in xla:
        assert xla[k].tobytes() == pallas[k].tobytes(), k


def test_ep_moe(runs):
    port, ref, _ = runs
    np.testing.assert_allclose(port["ep/y"], port["ep/moe"], rtol=0,
                               atol=EP_ATOL)
    np.testing.assert_allclose(port["ep/y"], ref["ep/y"], rtol=0,
                               atol=EP_ATOL)
    np.testing.assert_allclose(port["ep/aux"], ref["ep/aux"], rtol=1e-5)


def test_ring_collectives(runs):
    port, _, _ = runs
    y = tp.collective_inputs()["y"]
    np.testing.assert_allclose(port["ring/reduce"].reshape(8, 32),
                               np.tile(y.sum(0), (8, 1)), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(port["ring/gather"],
                                  np.broadcast_to(y, (8, 8, 32)))


def test_staged_all_gather(runs):
    """The functional all-gather's route for CUDA operands over gloo
    (``compat._all_gather_into_tensor``), here on host tensors."""
    port, _, _ = runs
    np.testing.assert_array_equal(port["staged_ag"],
                                  tp.collective_inputs()["y"])


def test_pipeline_forward(runs):
    port, _, _ = runs
    c = tp.collective_inputs()
    want = c["mbs"]
    for w in c["ws"]:
        want = np.tanh(want @ w)
    np.testing.assert_allclose(port["pipeline"][-1], want, rtol=0, atol=1e-5)
    assert not port["pipeline"][:-1].any()   # meaningful on the last stage


def test_compressed_psum_bits(runs):
    port, ref, _ = runs
    for k in ("cpsum/mean", "cpsum/residual"):
        assert port[k].tobytes() == ref[k].tobytes(), k
    y = tp.collective_inputs()["y"]
    assert np.abs(port["cpsum/mean"] - y.mean(0)).max() < 0.05


def test_compressed_training_converges(runs):
    port, _, _ = runs
    ref_l, cmp_l = port["dp/plain"], port["dp/compressed"]
    l0, lr_, lc = float(ref_l[0]), float(ref_l[-1]), float(cmp_l[-1])
    assert lr_ < l0 / 5, (l0, lr_)
    assert lc < l0 / 5, (l0, lc)
    assert lc < lr_ * 3 + 1e-3, (lr_, lc)


@pytest.mark.parametrize("into", ["plain", "mesh", "async"])
def test_sharded_snapshot_restores(runs, into):
    port, _, _ = runs
    assert bool(port[f"snapshot/{into}"])


def test_sharded_snapshot_bytes(runs):
    """A sharded LM's snapshot is the unsharded one's, file for file."""
    _, _, work = runs
    plain, sharded = work / "snap_plain" / "step_3", \
        work / "snap_sharded" / "step_3"
    names = sorted(f.name for f in plain.iterdir())
    assert names == sorted(f.name for f in sharded.iterdir())
    assert len(names) > 10
    for n in names:
        assert (plain / n).read_bytes() == (sharded / n).read_bytes(), n
