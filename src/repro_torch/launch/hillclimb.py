"""§Perf hillclimb runner: re-trace the selected cells under optimization
variants and record hypothesis -> change -> before -> after — the
counterpart of ``repro.launch.hillclimb``, through the port's dry run
(``launch.dryrun.run_cell``, a fake 256-rank group) and analytics (the
H100's constants).

Selected cells (the reference's):
  1. llama3-405b  x train_4k   — worst HBM capacity + huge FSDP gather term
  2. deepseek-v2  x train_4k   — the paper-technique cell (sort MoE dispatch,
                                 EP all_to_all); most collective-bound train
  3. glm4-9b      x decode_32k — collective-bound decode; weights-resident
                                 serving plan

Each variant is BOTH re-traced on the production mesh (proving the plan
holds and counting its FLOPs, bytes and collectives) AND evaluated with
the analytic model (launch/analytics.py).

    PYTHONPATH=src python -m repro_torch.launch.hillclimb [--only CELL]
"""

import argparse
import json
import os

from ..configs import SHAPES, get_config
from ..parallel.sharding import Rules
from .analytics import cell_analytics, hbm_capacity_check
from .dryrun import artifact_path, run_cell

VARIANTS = {
    # cell 1: llama3-405b train — hypothesis: SP shards saved residuals 16x,
    # letting accum drop 32 -> 8 -> 4, which cuts FSDP all-gather traffic
    # proportionally (the dominant term).
    "llama3-405b/train_4k": [
        dict(tag="baseline", accum=32, sp=False),
        dict(tag="sp_accum32", accum=32, sp=True),
        dict(tag="sp_accum8", accum=8, sp=True),
        dict(tag="sp_accum4", accum=4, sp=True),
        # int8+EF activation all-reduce: mechanism in parallel/compression.py
        # (tested against the reference's bits); modeled analytically, the
        # traced step unchanged.
        dict(tag="sp_accum8_int8ar", accum=8, sp=True, int8=True,
             analytic_only=True),
    ],
    # cell 2: deepseek-v2 train — same SP+accum lever; EP a2a stays constant
    # (payload is real tokens, the paper's sort dispatch keeps it compact).
    "deepseek-v2-236b/train_4k": [
        dict(tag="baseline", accum=8, sp=False),
        dict(tag="sp_accum4", accum=4, sp=True),
        dict(tag="sp_accum2", accum=2, sp=True),
        dict(tag="sp_accum1", accum=1, sp=True),
        dict(tag="sp_accum1_int8ar", accum=1, sp=True, int8=True,
             analytic_only=True),
    ],
    # cell 3: glm4-9b decode — hypothesis: params TP-resident (no FSDP
    # gather per step) turns the step collective term into pure activation
    # all-reduces.
    "glm4-9b/decode_32k": [
        dict(tag="baseline", accum=1, sp=False),
        dict(tag="resident", accum=1, sp=False, weights_resident=True),
    ],
    # bonus cell: nemotron prefill — hypothesis: the (T,S) score buffers in
    # the non-streaming path dominate the step's live memory; chunked
    # streaming attention removes them. Read on the traced peak bytes
    # (the record's memory block), not just the analytic model.
    "nemotron-4-340b/prefill_32k": [
        dict(tag="baseline", accum=1, sp=False),
        dict(tag="chunked_attn", accum=1, sp=False,
             cfg_overrides={"attn_kv_chunk": 2048}),
    ],
}


def rules_for(variant) -> Rules:
    r = Rules()
    if variant.get("sp"):
        r = r.override(res_seq="model")
    if variant.get("weights_resident"):
        r = r.override(embed=None)  # params shard over `model` only
    return r


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="artifacts/hillclimb")
    ap.add_argument("--only", default=None)
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)

    results = []
    for cell_key, variants in VARIANTS.items():
        if args.only and args.only not in cell_key:
            continue
        arch, shape = cell_key.split("/")
        cfg = get_config(arch)
        cell = SHAPES[shape]
        for v in variants:
            if v.get("analytic_only"):
                # the optimization does not change the traced step (e.g.
                # int8 collectives replace the AR implementation, not the
                # program structure) — record analytics only.
                rec = {"arch": arch, "shape": shape, "mesh": "16x16",
                       "kind": cell.kind, "accum": v["accum"],
                       "trace_s": 0.0, "tag": v["tag"]}
            else:
                rules = rules_for(v)
                rec = run_cell(arch, shape, multi_pod=False, rules=rules,
                               accum=v["accum"], extra_tag=v["tag"],
                               cfg_overrides=v.get("cfg_overrides"))
            # re-derive analytics with the variant's levers
            rec["analytic"] = cell_analytics(
                cfg, cell, multi_pod=False, accum=v["accum"],
                sp=v.get("sp", False),
                weights_resident=v.get("weights_resident", False),
                int8_collectives=v.get("int8", False))
            rec["hbm_capacity"] = hbm_capacity_check(
                cfg, cell, multi_pod=False, accum=v["accum"],
                sp=v.get("sp", False),
                weights_resident=v.get("weights_resident", False))
            rec["variant"] = v
            path = os.path.join(args.out, f"{arch}__{shape}__{v['tag']}.json")
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
            a = rec["analytic"]
            print(f"[{cell_key} :: {v['tag']}] trace={rec['trace_s']}s "
                  f"dominant={a['roofline']['bottleneck']} "
                  f"bound={a['step_time_bound_s']:.3f}s "
                  f"rooffrac={a['roofline_fraction']:.3f} "
                  f"hbm={rec['hbm_capacity']['total_gib']:.1f}GiB "
                  f"fits={rec['hbm_capacity']['fits']}")
            results.append(rec)
    print(f"\n{len(results)} variants recorded in {args.out}")


if __name__ == "__main__":
    main()
