"""Readings of a cell's check on many seeds: the program's numbers and the
control's, which the limits in ``workloads/<cell>.json`` are set between.

    python3 -m h100bench.control --workload <cell> --seeds 1,2,3 [--seconds 1] [--through-run]

The control is the plain reference put in the program's place in the
nearest precision below the configuration's: for the word sorts, key lanes
compared as float32 where the configuration states an exact uint32 order;
for a bfloat16 model, the reference with float8 e4m3 projections (it need
not decode: at each position of the served prompts and tokens, the gap of
the token it puts first). The benchmark's own runs never run it. Each seed
prints one JSON line; the program runs as in a run of the cell, the serving
cells over a short window at the cell's load.

With ``--through-run`` the control takes the program's place in a whole
run of the cell (``run.run_cell`` with the driver's ``control``): each
seed's line gives the run's ``correct``, which has to come out false, and
the numbers it compared.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import types

from . import bench
from .run import _environment


def sort_readings(cell, seed: int, device) -> dict:
    """One corpus of the cell's size: the program's rows and packed keys
    off the reference, and the control's."""
    from .drivers import _words
    from .reference import shortlex
    driver = bench.load_driver(cell.spec["driver"])
    state = driver.setup(dict_cell(cell, pool=1), seed, device)
    keys, lens = state["pool"][0]
    got = tuple(_words._host(x) for x in state["call"](keys, device))
    want = shortlex.sort(lens, keys)
    want_packed = shortlex.pack(*want)
    ctl = shortlex.control_sort(lens, keys)
    out = {"seed": seed, "words": len(keys),
           "program_rows_off": shortlex.rows_off(*want, got[0], got[1]),
           "control_rows_off": shortlex.rows_off(*want, *ctl)}
    if got[2]:
        out["program_packed_off"] = shortlex.packed_off(want_packed, got[2])
        out["control_packed_off"] = shortlex.packed_off(
            want_packed, shortlex.pack(*ctl))
    return out


def dict_cell(cell, **traffic):
    import dataclasses
    return dataclasses.replace(cell, traffic=dict(cell.traffic, **traffic))


def serve_readings(cell, seed: int, device, seconds: float) -> dict:
    driver = bench.load_driver(cell.spec["driver"])
    state = driver.setup(cell, seed, device)
    win = bench.Window(seconds)
    records = driver.window(state, win, bench.Spans(False))
    numbers = driver.check(state, records, control=True)
    return {"seed": seed, "waves": records["calls"],
            **{name: v for name, v, _ in numbers}}


def through_run(cell, seed: int, device, seconds: float) -> dict:
    """A run of the cell with the control in the program's place."""
    from .run import run_cell
    real = bench.load_driver(cell.spec["driver"])

    def setup(c, s, d):
        state = real.setup(c, s, d)
        real.control(state)
        return state

    driver = types.SimpleNamespace(setup=setup, window=real.window,
                                   check=real.check)
    r = run_cell(cell, seed, seconds, False, device, time.perf_counter(),
                 driver=driver)
    return {"seed": seed, "correct": r["correct"], "attempted": r["attempted"],
            "failed": r["failed"],
            **{name: c["value"] for name, c in r["checks"].items()}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m h100bench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--through-run", action="store_true")
    args = p.parse_args(argv)
    cell = bench.load_cell(args.workload)
    _environment()
    import torch
    if not torch.cuda.is_available():
        print("h100bench.control: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        if args.through_run:
            out = through_run(cell, seed, device, args.seconds)
        elif cell.spec["driver"] == "serve_scheduler":
            out = serve_readings(cell, seed, device, args.seconds)
        else:
            out = sort_readings(cell, seed, device)
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
