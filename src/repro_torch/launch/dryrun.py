"""Multi-pod dry run: trace every (arch x shape x mesh) cell's step over a
fake 256- or 512-rank process group — the counterpart of
``repro.launch.dryrun``, which lowers and compiles each cell for 256/512
placeholder XLA devices.

For each cell this runs the cell's step once, the train step, the prefill
or the decode step, with no real allocation: every parameter, optimizer
moment, cache leaf and input is a ``DTensor`` on a CPU ``DeviceMesh`` over
a ``"fake"`` process group, its local shard a ``meta`` tensor (shape and
dtype, no memory), so every op the step runs on rank 0's shards is a
``meta`` op and every collective a ``meta`` op too. A run that completes
proves the sharding plan coherent, as a compile did for the reference:
every redistribution the plan implies has a rule, every op a sharding
strategy. Rank 0's local ops, the ``meta`` ones, are counted as they run;
DTensor's own planning on the host (real CPU tensors) and its shape
inference (fake tensors) are not:

  * ``flops_per_device`` — the FLOPs of rank 0's local products (the
    formulas of ``torch.utils.flop_counter``), beside ``flops_global``,
    the same count over the step's global (DTensor-level) ops, which is
    what the step computes unsharded. Their difference, times the ranks,
    is ``flops_redundant``: work that every rank repeats in full (the MoE
    dispatch's routing on the whole token list, replicated weights' products).
    A ``FlopCounterMode`` above ``DTensor`` sees only the global ops, so
    the global count divided by the ranks would hide that;
  * ``hbm_bytes_per_device`` — every non-view local op's tensor inputs
    read once and its outputs written once (no fusion: an upper bound, as
    XLA's "bytes accessed" is);
  * ``collectives`` — ``{kind: {count, bytes}}`` under the reference's five
    names, from c10d's functional collectives on rank 0 (their output
    bytes);
  * ``memory`` — rank 0's bytes of parameters, optimizer state, cache and
    inputs, and ``peak_bytes``, the most bytes of live ``meta`` storage
    at any op of the step (the counterpart of ``memory_analysis``).

``roofline`` reads those through :func:`roofline_terms` (the H100's
constants, ``launch.hw``); ``analytic`` and ``hbm_capacity`` are the closed
forms of ``launch.analytics``. The XLA-only keys ``lower_s``,
``compile_s`` and ``generated_code_size_bytes`` are one ``trace_s`` here.
The reference's ``_shape_bytes`` and ``parse_collectives`` read XLA HLO
text, which the port has none of: they are not ported, by design.

Importing this module sets no environment variable and starts no process
group. :func:`run_cell` makes the fake group and destroys it before it
returns, so the process can make a real group afterwards; it refuses to
run where a default group exists already. The MoE dispatch runs with
``sort_impl='xla'`` (``torch.argsort``): the hand-written kernels are
launched through ctypes, which cannot take ``meta`` tensors; the record
says so.

Artifacts land in artifacts/dryrun/<mesh>/<arch>__<shape>.json;
``--table`` prints them as one markdown row a cell, its meshes side by
side:

    PYTHONPATH=src python -m repro_torch.launch.dryrun \
        [--arch ID|all] [--shape NAME|all] [--mesh single|multi|both]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --table
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback
import weakref

import torch
from torch import nn
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from ..configs import ARCH_IDS, SHAPES, ShapeCell, cells_for, get_config
from ..models.model import decode_step, forward
from ..parallel.compat import make_mesh, set_mesh
from ..parallel.sharding import Rules
from ..training.steps import Hyper, make_train_step
from . import hw
from .analytics import cell_analytics, hbm_capacity_check
from .specs import count_params, input_specs

__all__ = ["TRAIN_ACCUM", "SORT_IMPL", "roofline_terms", "build_step",
           "fake_group", "run_cell", "artifact_path",
           "table", "main"]

# Per-arch microbatch accumulation for train_4k: the reference's, chosen so
# layer-boundary activations fit a v5e's 16 GiB; re-sizing them for the
# H100's 80 GB is later work.
TRAIN_ACCUM = {
    "llama3-405b": 32,
    "nemotron-4-340b": 32,
    "deepseek-v2-236b": 8,
    "glm4-9b": 4,
    "minicpm3-4b": 2,
    "musicgen-large": 2,
    "zamba2-1.2b": 2,
}

# the MoE dispatch's sort on `meta` shards (the module's docstring)
SORT_IMPL = "xla"

_META = torch.device("meta")

_COLLECTIVE_KINDS = (("all_gather", "all-gather"),
                     ("reduce_scatter", "reduce-scatter"),
                     ("all_reduce", "all-reduce"),
                     ("all_to_all", "all-to-all"),
                     ("permute", "collective-permute"),
                     ("send", "collective-permute"),
                     ("recv", "collective-permute"))


def roofline_terms(flops, hbm_bytes, collectives):
    compute_s = flops / hw.PEAK_FLOPS_BF16
    memory_s = hbm_bytes / hw.HBM_BW
    coll_bytes_eff = sum(
        v["bytes"] * hw.COLLECTIVE_MULTIPLIER[k] for k, v in collectives.items()
    )
    collective_s = coll_bytes_eff / hw.NVLINK_BW
    terms = {"compute_s": compute_s, "memory_s": memory_s, "collective_s": collective_s}
    terms["bottleneck"] = max(terms, key=lambda k: terms[k] if k.endswith("_s") else -1)
    return terms


def build_step(cfg, cell, rules: Rules, accum: int = 1):
    if cell.kind == "train":
        hyper = Hyper(accum=accum, sort_impl=SORT_IMPL)
        return make_train_step(cfg, rules, hyper)
    if cell.kind == "prefill":
        def prefill_step(params, batch):
            logits, _, cache = forward(cfg, params, batch, rules,
                                       sort_impl=SORT_IMPL, return_cache=True)
            return logits, cache
        return prefill_step

    def serve_step(params, cache, tok, cur):
        return decode_step(cfg, params, cache, tok, cur, rules,
                           sort_impl=SORT_IMPL)
    return serve_step


# ---------------- counting ----------------

def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _tensors(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _tensors(x)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _collective_kind(func):
    """The reference's name of a c10d collective; ``""`` for c10d's
    bookkeeping (waits, autograd wrappers: no transfer); ``None`` for any
    other op."""
    ns = func.namespace
    if not ns.startswith(("_c10d_functional", "c10d")):
        return None
    name = func._opname
    if name.startswith(("wait", "_wrap")):
        return ""
    for key, kind in _COLLECTIVE_KINDS:
        if key in name:
            return kind
    raise ValueError(f"collective {func} has no kind of the reference's")


class _Count:
    """What one level of ops adds up to: FLOPs, and for the local level
    bytes accessed, collectives and live storage."""

    def __init__(self):
        self.flops = 0
        self.by_op: dict = {}
        self.hbm_bytes = 0
        self.collectives: dict = {}
        self.live = 0
        self.peak = 0
        self._storages: dict = {}

    def add_flops(self, func, args, kwargs, out):
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            n = int(formula(*args, **(kwargs or {}), out_val=out))
            self.flops += n
            name = str(func._overloadpacket)
            self.by_op[name] = self.by_op.get(name, 0) + n

    def track(self, out):
        """Count every new storage among ``out``'s tensors as live until it
        is freed."""
        for t in _tensors(out):
            st = t.untyped_storage()
            key = id(st)
            if key in self._storages:
                continue
            n = st.nbytes()

            def gone(_, key=key, n=n):
                self._storages.pop(key, None)
                self.live -= n
            self._storages[key] = weakref.ref(st, gone)
            self.live += n
        self.peak = max(self.peak, self.live)


def _rank_op(args, out) -> bool:
    """Whether an op is one of rank 0's local ops: it touches a ``meta``
    tensor that is not a fake one (DTensor's shape inference fakes its
    own)."""
    ts = list(_tensors(args)) + list(_tensors(out))
    return (any(t.device.type == "meta" for t in ts)
            and not any(isinstance(t, FakeTensor) for t in ts))


class _TraceMode(TorchDispatchMode):
    """Counts rank 0's local ops: a ``DTensor`` op is passed on to
    ``DTensor``, whose local ops come back here."""

    def __init__(self):
        super().__init__()
        self.count = _Count()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        if not _rank_op(args, out):
            return out
        c = self.count
        kind = _collective_kind(func)
        if kind:
            rec = c.collectives.setdefault(kind, {"count": 0, "bytes": 0})
            rec["count"] += 1
            rec["bytes"] += sum(_nbytes(t) for t in _tensors(out))
        elif kind is None:
            c.add_flops(func, args, kwargs, out)
            read = sum(_nbytes(t) for t in _tensors(args))
            if read and not func.is_view:
                c.hbm_bytes += read + sum(_nbytes(t) for t in _tensors(out))
        c.track(out)
        return out


class _GlobalFlops(TorchDispatchMode):
    """The step's FLOPs at the level of its own calls: ``DTensor`` ops with
    their global shapes, plain ops as they are — what the step computes
    unsharded."""

    def __init__(self):
        super().__init__()
        self.count = _Count()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.count.add_flops(func, args, kwargs, out)
        return out


# ---------------- the fake mesh and its inputs ----------------

def _mesh_layout(multi_pod: bool, mesh_shape):
    if mesh_shape is None:
        mesh_shape = (2, 16, 16) if multi_pod else (16, 16)
    mesh_shape = tuple(mesh_shape)
    names = {2: ("data", "model"), 3: ("pod", "data", "model")}[
        len(mesh_shape)]
    return mesh_shape, names


def _mesh_label(shape) -> str:
    return "x".join(map(str, shape))


@contextlib.contextmanager
def fake_group(world: int):
    """A ``"fake"`` default process group of ``world`` ranks, this process
    rank 0, destroyed on leaving."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("the dry run makes its own fake process group; "
                           "a default group exists already")
    dist.init_process_group("fake", rank=0, world_size=world,
                            store=FakeStore())
    try:
        yield
    finally:
        dist.destroy_process_group()


def _local_shape(shape, placements, mesh):
    local = list(shape)
    for i, p in enumerate(placements):
        if p.is_shard():
            if local[p.dim] % mesh.size(i):
                raise ValueError(f"dimension {p.dim} of {tuple(shape)} does "
                                 f"not divide over mesh axis {i}")
            local[p.dim] //= mesh.size(i)
    return tuple(local)


def _placed(x: torch.Tensor, sharding):
    """A ``DTensor`` of ``x``'s global shape and dtype, its local shard a
    fresh ``meta`` tensor; a plain ``meta`` tensor where the spec is that
    of a scalar."""
    if x.dim() == 0:
        return torch.zeros((), dtype=x.dtype, device=_META)
    pl = sharding.placements
    local = torch.empty(_local_shape(x.shape, pl, sharding.mesh),
                        dtype=x.dtype, device=_META)
    return DTensor.from_local(local, sharding.mesh, pl, run_check=False,
                              shape=x.shape, stride=x.stride())


def _placed_tree(tree, shardings):
    if isinstance(tree, dict):
        return {k: _placed_tree(v, shardings[k]) for k, v in tree.items()}
    return _placed(tree, shardings)


def _placed_lm(lm: nn.Module, shardings, requires_grad: bool):
    for name, p in list(lm.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        setattr(lm.get_submodule(owner), leaf,
                nn.Parameter(_placed(p, shardings[name]),
                             requires_grad=requires_grad))
    return lm


def _local_bytes(tree) -> int:
    if isinstance(tree, nn.Module):
        tree = dict(tree.named_parameters())
    return sum(_nbytes(t.to_local() if isinstance(t, DTensor) else t)
               for t in _tensors(tree))


# ---------------- one cell ----------------

# what each of a step's arguments is, for the memory block
_ROLES = {"train": ("params", "opt_state", "input", "input"),
          "prefill": ("params", "input"),
          "decode": ("params", "cache", "input", "input")}

def run_cell(arch_id: str, shape_name, multi_pod: bool,
             rules: Rules | None = None, accum: int | None = None,
             extra_tag: str = "", cfg_overrides: dict | None = None,
             mesh_shape=None):
    """Trace one cell's step over a fake group and return its record.
    ``shape_name``: a name of ``configs.SHAPES`` or a ``ShapeCell``;
    ``mesh_shape``: the mesh, ``(data, model)`` or ``(pod, data, model)``
    (default the production 16 x 16, or 2 x 16 x 16 with ``multi_pod``)."""
    cfg = get_config(arch_id)
    if cfg_overrides:
        cfg = cfg.replace(**cfg_overrides)
    cell = shape_name if isinstance(shape_name, ShapeCell) \
        else SHAPES[shape_name]
    rules = rules or Rules()
    shape, names = _mesh_layout(multi_pod, mesh_shape)
    n_dev = math.prod(shape)
    if accum is None:
        accum = TRAIN_ACCUM.get(arch_id, 1) if cell.kind == "train" else 1
    train = cell.kind == "train"

    t0 = time.time()
    with fake_group(n_dev):
        mesh = make_mesh(shape, names, "cpu")
        args, shardings = input_specs(cfg, cell, rules, mesh)
        step = build_step(cfg, cell, rules, accum)
        trace, top = _TraceMode(), _GlobalFlops()
        with trace:
            placed = [_placed_lm(args[0], shardings[0], train)]
            placed += [_placed_tree(a, s)
                       for a, s in zip(args[1:], shardings[1:])]
            memory = dict.fromkeys(
                ("params_bytes", "opt_state_bytes", "cache_bytes",
                 "input_bytes"), 0)
            for role, a in zip(_ROLES[cell.kind], placed):
                memory[role + "_bytes"] += _local_bytes(a)
            c = trace.count
            c.flops = c.hbm_bytes = 0
            c.by_op.clear()
            c.peak = c.live
            memory["resident_bytes"] = c.live
            grad = contextlib.nullcontext() if train else torch.no_grad()
            with set_mesh(mesh), grad, top:
                out = step(*placed)
            del out, placed
        memory["peak_bytes"] = c.peak
    trace_s = time.time() - t0

    flops = float(c.flops)
    flops_global = float(top.count.flops)
    collectives = {k: dict(v) for k, v in sorted(c.collectives.items())}
    terms = roofline_terms(flops, float(c.hbm_bytes), collectives)
    analytic = cell_analytics(cfg, cell, multi_pod, accum)
    capacity = hbm_capacity_check(cfg, cell, multi_pod, accum)

    total_p, active_p = count_params(cfg)
    tokens = cell.global_batch * (cell.seq_len if cell.kind != "decode" else 1)
    mult = 6 if cell.kind == "train" else 2
    model_flops_global = mult * active_p * tokens
    model_flops_per_dev = model_flops_global / n_dev
    useful_ratio = model_flops_per_dev / flops if flops else None

    record = {
        "arch": arch_id,
        "shape": cell.name,
        "kind": cell.kind,
        "mesh": _mesh_label(shape),
        "devices": n_dev,
        "accum": accum,
        "trace_s": round(trace_s, 2),
        "flops_per_device": flops,
        "flops_global": flops_global,
        "flops_redundant": flops * n_dev - flops_global,
        # by op, where rank 0's products times the ranks exceed the global
        "flops_redundant_by_op": {
            k: v * n_dev - top.count.by_op.get(k, 0)
            for k, v in sorted(c.by_op.items())
            if v * n_dev != top.count.by_op.get(k, 0)},
        "hbm_bytes_per_device": float(c.hbm_bytes),
        "collectives": collectives,
        "roofline": terms,          # rank 0's traced ops
        "analytic": analytic,       # closed-form, launch/analytics.py
        "hbm_capacity": capacity,
        "params_total": total_p,
        "params_active": active_p,
        "model_flops_per_device": model_flops_per_dev,
        "useful_flops_ratio": useful_ratio,
        "memory": memory,
        "sort_impl": SORT_IMPL,
        "tag": extra_tag,
    }
    if cfg_overrides:
        record["cfg_overrides"] = dict(cfg_overrides)
    if not isinstance(shape_name, str):
        record["cell"] = dataclasses.asdict(cell)
    return record


def artifact_path(record, out_dir="artifacts/dryrun"):
    d = os.path.join(out_dir, record["mesh"])
    os.makedirs(d, exist_ok=True)
    tag = f"__{record['tag']}" if record["tag"] else ""
    return os.path.join(d, f"{record['arch']}__{record['shape']}{tag}.json")


def table(out_dir="artifacts/dryrun") -> str:
    """The artifacts under ``out_dir`` as one markdown row a cell, each
    column's values by mesh joined with " / " (16x16 / 2x16x16): trace
    seconds, FLOPs a rank (traced, and the analytic share), the redundant
    share of a rank's FLOPs, bytes accessed, collective and peak live bytes
    a rank, and whether the peak fits 80 GB against the analytic
    ``fits``."""
    recs: dict = {}
    for d, _, files in os.walk(out_dir):
        for name in files:
            if name.endswith(".json"):
                with open(os.path.join(d, name)) as f:
                    r = json.load(f)
                recs.setdefault((r["arch"], r["shape"], r["tag"]),
                                []).append(r)
    rows = ["| arch | cell | meshes | trace s | FLOPs/rank | analytic "
            "FLOPs/rank | redundant | bytes/rank | coll. B/rank | peak "
            "B/rank | peak fits 80 GB | analytic fits |", "|" + "---|" * 12]
    for (arch, shape, tag), rs in sorted(recs.items()):
        rs.sort(key=lambda r: r["devices"])

        def col(fn):
            return " / ".join(fn(r) for r in rs)
        rows.append(" | ".join([
            f"| {arch}", shape + (f" ({tag})" if tag else ""),
            col(lambda r: r["mesh"]), col(lambda r: f"{r['trace_s']:.0f}"),
            col(lambda r: f"{r['flops_per_device']:.3g}"),
            col(lambda r: f"{r['analytic']['flops_per_device']:.3g}"),
            col(lambda r: f"{r['flops_redundant'] / (r['flops_per_device'] * r['devices']):.2f}"),
            col(lambda r: f"{r['hbm_bytes_per_device']:.3g}"),
            col(lambda r: f"{sum(v['bytes'] for v in r['collectives'].values()):.3g}"),
            col(lambda r: f"{r['memory']['peak_bytes']:.3g}"),
            col(lambda r: "yes" if r["memory"]["peak_bytes"] <= hw.HBM_BYTES
                else "no"),
            col(lambda r: "yes" if r["hbm_capacity"]["fits"] else "no")])
            + " |")
    return "\n".join(rows)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all", help="arch id or 'all'")
    ap.add_argument("--shape", default="all", help="shape name or 'all'")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default="artifacts/dryrun")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--table", action="store_true",
                    help="print the artifacts under --out as a markdown "
                    "table and trace nothing")
    args = ap.parse_args(argv)
    if args.table:
        print(table(args.out))
        return

    archs = ARCH_IDS if args.arch == "all" else [args.arch]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    failures = []
    for arch in archs:
        cfg = get_config(arch)
        cells = cells_for(cfg)
        for cell in cells:
            if args.shape != "all" and cell.name != args.shape:
                continue
            for mp in meshes:
                tagp = f"{arch} x {cell.name} x {'2x16x16' if mp else '16x16'}"
                probe = {"arch": arch, "shape": cell.name,
                         "mesh": "2x16x16" if mp else "16x16", "tag": ""}
                path = artifact_path(probe, args.out)
                if args.skip_existing and os.path.exists(path):
                    print(f"[skip] {tagp}")
                    continue
                try:
                    rec = run_cell(arch, cell.name, mp)
                    with open(artifact_path(rec, args.out), "w") as f:
                        json.dump(rec, f, indent=1)
                    r = rec["roofline"]
                    print(f"[ok]   {tagp}: trace={rec['trace_s']}s "
                          f"flops/dev={rec['flops_per_device']:.3e} "
                          f"bottleneck={r['bottleneck']}", flush=True)
                except Exception as e:
                    failures.append((tagp, str(e)))
                    print(f"[FAIL] {tagp}: {e}", flush=True)
                    traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILURES")
        for t, e in failures:
            print(" -", t, e.splitlines()[0] if e else "")
        raise SystemExit(1)
    print("\nALL CELLS PASSED")


if __name__ == "__main__":
    main()
