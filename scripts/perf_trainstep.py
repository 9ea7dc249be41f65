#!/usr/bin/env python
"""Time the default differentiable train step at scale on the GPU.

Records the train-step time at >=256^2 in docs/TRAINSTEP.json.  The step
is make_train_step's step_fn — forward SPPM pass + full backward (the
bruteforce deposit custom VJP, ``diff.vjp.deposit_bruteforce_vjp``,
Newton IFT VJP, texture/albedo VJPs) + Adam update.

Usage:
  python scripts/perf_trainstep.py [--res 256] [--steps 6]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--res", type=int, default=256)
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--photons", type=int, default=32768)
    ap.add_argument("--out", default=os.path.join(REPO, "docs",
                                                  "TRAINSTEP.json"))
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np

    from raytrace3_tpu.backends import select_backends
    from raytrace3_tpu.diff.train import extract_params, make_train_step
    from raytrace3_tpu.render.driver import build_scene
    from raytrace3_tpu.utils.cache import enable_compile_cache
    from raytrace3_tpu.utils.config import RenderConfig

    enable_compile_cache()

    cfg = RenderConfig(
        scene="full", width=args.res, height=args.res, rounds=args.rounds,
        photons_per_round=args.photons, max_depth=13, atlas_res=64,
        bezier_compact_frac=0.12, bezier_compact_frac_photon=0.06,
        hitpoint_factor=1.5,
    )
    scene = build_scene(cfg)
    _, newton_fn = select_backends(cfg, scene)

    init_fn, step_fn = make_train_step(scene, cfg, newton_fn=newton_fn)
    params = extract_params(scene)
    opt_state = init_fn(params)
    key = jax.random.key(0)
    target = jnp.zeros((cfg.height, cfg.width, 3))

    t0 = time.perf_counter()
    params, opt_state, loss, tstats = step_fn(params, opt_state, key, target)
    jax.block_until_ready(loss)
    assert int(tstats["deposits_dropped"]) == 0, tstats
    compile_s = time.perf_counter() - t0
    print(f"trainstep: compile+first {compile_s:.1f}s loss={float(loss):.4g}",
          file=sys.stderr, flush=True)

    # steady state: pre-fold keys, dispatch all, one scalar drain
    keys = [jax.random.fold_in(key, i + 1) for i in range(args.steps)]
    jax.block_until_ready(keys)
    losses = []
    t0 = time.perf_counter()
    for k in keys:
        params, opt_state, loss, _ = step_fn(params, opt_state, k, target)
        losses.append(loss)
    jax.device_get(jnp.stack(losses).sum())
    dt = (time.perf_counter() - t0) / args.steps

    record = {
        "what": "full differentiable SPPM train step (fwd+bwd+adam), "
                "bruteforce deposit VJP",
        "res": args.res,
        "photons_per_step": cfg.rounds * cfg.photons_per_round,
        "device": {"platform": jax.devices()[0].platform,
                   "kind": jax.devices()[0].device_kind,
                   "count": len(jax.devices())},
        "steps_timed": args.steps,
        "step_seconds": dt,
        "compile_seconds": compile_s,
        "loss_finite": bool(np.isfinite(float(losses[-1]))),
    }
    assert record["loss_finite"], record
    with open(args.out, "w") as f:
        json.dump(record, f, indent=2)
        f.write("\n")
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
