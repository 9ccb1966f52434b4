"""Post-hoc enrichment: add the analytic roofline and HBM-capacity blocks
to dry-run artifacts, with no new trace — the counterpart of
``repro.launch.enrich``, through the port's analytics (the H100's
constants).

    PYTHONPATH=src python -m repro_torch.launch.enrich [--dir artifacts/dryrun]
"""

from __future__ import annotations

import argparse
import glob
import json
import os

from ..configs import SHAPES, get_config
from .analytics import cell_analytics, hbm_capacity_check


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="artifacts/dryrun")
    args = ap.parse_args(argv)
    n = 0
    for path in glob.glob(os.path.join(args.dir, "*", "*.json")):
        with open(path) as f:
            rec = json.load(f)
        cfg = get_config(rec["arch"])
        cell = SHAPES[rec["shape"]]
        multi_pod = rec["mesh"] == "2x16x16"
        rec["analytic"] = cell_analytics(cfg, cell, multi_pod, rec.get("accum", 1))
        rec["hbm_capacity"] = hbm_capacity_check(cfg, cell, multi_pod, rec.get("accum", 1))
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        n += 1
    print(f"enriched {n} artifacts")


if __name__ == "__main__":
    main()
