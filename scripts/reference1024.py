#!/usr/bin/env python
"""Run the reference's own converged workload and record the artifact.

The reference publishes exactly one workload (README.md:349-351 + Camera.h:
16-17): a 1024x1024 canvas converged over ~50M photons.  This script runs
the ``reference1024`` preset (utils/config.py) end to end through the cli
on the GPU, writes the converged PNG, and records the in-pass throughput
medians in docs/REFERENCE1024.json.

Usage:
  python scripts/reference1024.py [--passes 50] \
      [--out docs/REFERENCE1024.json]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--passes", type=int, default=50)
    ap.add_argument("--out", default=os.path.join(REPO, "docs",
                                                  "REFERENCE1024.json"))
    ap.add_argument("--png", default=os.path.join(REPO, "docs",
                                                  "reference1024.png"))
    ap.add_argument("--metrics", default=os.path.join(
        REPO, "docs", "reference1024_metrics.jsonl"))
    args = ap.parse_args()

    import jax

    from raytrace3_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()

    import numpy as np

    from raytrace3_tpu import cli

    if os.path.exists(args.metrics):
        os.remove(args.metrics)
    rc = cli.main([
        "--preset", "reference1024",
        "--passes", str(args.passes),
        "--out", args.png,
        "--metrics-jsonl", args.metrics,
        "--checkpoint-every", "0",
        # the per-pass progressive preview (cli default, reference parity)
        # puts host PNG I/O inside the timed loop — off for the throughput
        # artifact
        "--preview-every", "0",
    ])
    assert rc == 0

    recs = [json.loads(l) for l in open(args.metrics)]
    ps = np.array([r["pass_seconds"] for r in recs])
    pps = np.array([r["photons_per_s"] for r in recs])
    emitted = pps * ps
    mrays = np.array([r.get("mrays_per_s", 0.0) for r in recs])
    eye_dropped = int(sum(r.get("dropped", 0) for r in recs))
    dep_dropped = int(sum(r.get("deposits_dropped", 0) for r in recs))
    record = {
        "preset": "reference1024 (the reference's converged workload: "
                  "1024^2, ~50M photons, README.md:349-351)",
        "passes": len(recs),
        "photons_per_pass": int(np.median(emitted)),
        "photons_total": int(emitted.sum()),
        # medians: pass 1 includes the compile
        "device": {"platform": jax.devices()[0].platform,
                   "kind": jax.devices()[0].device_kind},
        "pass_seconds_median": float(np.median(ps)),
        "photons_per_s_in_pass_median": float(np.median(pps)),
        "mrays_per_s_median": float(np.median(mrays)),
        "hitpoints_final": int(recs[-1].get("hitpoints", 0)),
        "deposits_dropped_total": dep_dropped,
        "eye_dropped_total": eye_dropped,
        "mean_r2_final": round(float(recs[-1].get("mean_r2", 0.0)), 4),
        "image": os.path.relpath(args.png, REPO),
    }
    with open(args.out, "w") as f:
        json.dump(record, f, indent=2)
        f.write("\n")
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
