"""Sets of runs of one cell and the spread of each metric, which its
bound is set from.

    python3 -m h100bench.spread --workload <cell> --seeds 1,2,3,4,5,6 [--sets 2] [--seconds 30] [--trace 0] [--out FILE]

Each run is its own process (``python3 -m h100bench.run``), every set
takes the seeds in the same order. For each metric and set the spread is
the distance between the first and third quartile
(``statistics.quantiles(values, n=4)``) as a share of the median; the
last line gives the wider of the sets' spreads, and each set's median.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

from .bench import CHECKOUT


def spread(values) -> float:
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def one_run(workload: str, seed: int, seconds: float, trace: int) -> dict:
    cmd = [sys.executable, "-m", "h100bench.run", "--workload", workload,
           "--seed", str(seed), "--seconds", str(seconds), "--trace",
           str(trace)]
    p = subprocess.run(cmd, capture_output=True, text=True, cwd=CHECKOUT)
    lines = p.stdout.strip().splitlines()
    try:
        result = json.loads(lines[-1]) if p.returncode == 0 else None
    except (IndexError, json.JSONDecodeError):
        result = None
    return {"seed": seed, "rc": p.returncode, "result": result,
            "stderr": p.stderr[-1500:] if result is None else
            p.stderr.strip().splitlines()[-8:]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m h100bench.spread")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--sets", type=int, default=2)
    ap.add_argument("--seconds", type=float, default=30)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    out = Path(args.out) if args.out else None
    values: dict = {}
    for k in range(args.sets):
        for seed in seeds:
            r = one_run(args.workload, seed, args.seconds, args.trace)
            r["set"] = k
            line = json.dumps(r)
            print(line, flush=True)
            if out is not None:
                with out.open("a") as f:
                    f.write(line + "\n")
            if r["result"] is None:
                continue
            for name, m in r["result"]["metrics"].items():
                values.setdefault(name, {}).setdefault(k, []).append(
                    m["value"])
    summary = {}
    for name, sets in values.items():
        per = {k: {"median": statistics.median(v),
                   "spread": spread(v) if len(v) >= 2 else None}
               for k, v in sets.items()}
        widest = max((s["spread"] for s in per.values()
                      if s["spread"] is not None), default=None)
        summary[name] = {"sets": per, "widest_spread": widest}
    print(json.dumps({"workload": args.workload, "summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
