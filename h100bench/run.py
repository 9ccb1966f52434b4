"""Run one cell of ``BENCHMARK.json`` and print its result line.

    python3 -m h100bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (loading, the kernels' build on a checkout's first run, the
inputs, the warm-up of every shape the cell uses) is timed from the start
of the process as ``setup_s``. Then the window runs for ``--seconds``;
with ``--trace 1`` the profiler traces its first units and the line
carries the cell's per-layer metrics, else its end-to-end ones. After the
window the peak memory is read, the program's state is freed and the
answers are compared with the plain references. The numbers compared,
each with its limit, close standard error and the line's ``checks``.

The run exits non-zero and prints no result where there is no card (or
fewer than the cell asks for), where the port's sources are missing, and
where ``jax``, ``jaxlib``, ``flax`` or the JAX package ``repro`` is loaded
once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from . import bench, peaks  # noqa: E402
from .trace import Tracer  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is one
    of :data:`FORBIDDEN`, compared whole: ``repro_torch`` is not
    ``repro``."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def _parse(argv):
    p = argparse.ArgumentParser(prog="python3 -m h100bench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _environment():
    """The port's sources on the path, and every build and kernel cache at
    a fixed place inside the checkout (the port's kernels build into its
    own ``build/kernels/``)."""
    src = bench.CHECKOUT / "src"
    if not (src / "repro_torch").is_dir():
        raise FileNotFoundError(f"the port is missing: no {src / 'repro_torch'}")
    if str(src) not in sys.path:
        sys.path.insert(0, str(src))
    build = bench.CHECKOUT / "build"
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch_extensions"))
    os.environ.setdefault("USE_FLAX", "0")


def _launch_counts() -> dict:
    from repro_torch.kernels._build import KERNELS
    return {name: k.launches for name, k in KERNELS.items()}


def _sums(dicts) -> dict:
    out: dict = {}
    for d in dicts:
        for k, v in d.items():
            out[k] = out.get(k, 0) + v
    return out


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, driver=None) -> dict:
    """Set up, run and check one cell on ``device``; returns the result
    dict (``checks`` last). ``driver`` replaces the cell's own (tests break
    the timed path underneath with it)."""
    import torch
    driver = driver or bench.load_driver(cell.spec["driver"])
    on_card = device.type == "cuda"
    spans = bench.Spans(trace)
    state = driver.setup(cell, seed, device)
    if on_card:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start

    tracer = Tracer(cell.spec["trace_units"], spans) if trace and on_card \
        else None
    before = _launch_counts()
    win = bench.Window(seconds, tracer)
    records = driver.window(state, win, spans)
    after = _launch_counts()
    records["window_s"] = win.seconds
    records["launches"] = {k: after[k] - before.get(k, 0) for k in after}
    per_unit = records.get("per_unit", [])
    if tracer is not None and tracer.result is not None:
        tr = tracer.result
        tr["counts"] = _sums(per_unit[:min(tracer.units, win.units)])
        records["trace"] = tr
    else:
        records["trace"] = None
    records["spans"] = spans.items
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0

    numbers = driver.check(state, records)
    del state
    correct = records["attempted"] > 0 and records["failed"] == 0 and all(
        lim is None or v <= lim for _, v, lim in numbers)

    if trace:
        metrics = {}
        for m in cell.per_layer:
            v = bench.load_metric(m["name"])(records)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = dict(records["metrics"], setup_s=setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end if m["name"] in values}
    dev = {"platform": "gpu" if on_card else device.type,
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": cell.entry["chips"], "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": records["attempted"],
              "failed": records["failed"], "metrics": metrics, "device": dev}
    if trace:
        tr = records["trace"]
        dev["busy_s"] = tr["busy_s"] if tr else 0.0
        dev["window_s"] = tr["window_s"] if tr else records["window_s"]
        if tr:
            ops = sorted(tr["ops"].items(), key=lambda kv: -kv[1][0])
            result["breakdown"] = {
                "device_ops": [[n, s] for n, (s, _) in ops[:10]],
                "idle_gaps": [[label, s] for label, s in tr["gaps"][:10]]}
    result["checks"] = {name: {"value": v, "limit": lim}
                        for name, v, lim in numbers}
    return result


def main(argv=None) -> int:
    args = _parse(argv)
    try:
        cell = bench.load_cell(args.workload)
        _environment()
    except (FileNotFoundError, KeyError) as e:
        print(f"h100bench: {e}", file=sys.stderr)
        return 2
    import torch
    chips = cell.entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"h100bench: the cell needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.set_num_threads(2)
    print(f"card: {peaks.power_limit()}", file=sys.stderr)

    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      device, T_START)

    found = forbidden_modules()
    if found:
        print(f"h100bench: loaded in this process: {', '.join(found)}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        lim = "none" if c["limit"] is None else c["limit"]
        print(f"check {name}: {c['value']} limit {lim}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
