#!/usr/bin/env python
"""Geometry recovery via the smooth deposit kernel + kernel-radius anneal.

The round-5 resolution of the docs/INVERSE_CTRL.json negative result
(VERDICT round 4 item 4), in two measured steps:

1. The box->Epanechnikov kernel swap (render/deposit.py) removes the
   radius-boundary jumps, so the FIXED-KEY (common-random-numbers) loss is
   a.e. smooth in geometry with its minimum exactly at the truth — the
   staircase that defeated every box-kernel CRN attempt is gone.  Measured
   alone it descends monotonically but stalls (loss 0.021 -> 0.0125,
   surface err 0.0275 -> 0.0231 at r2 = 2): the caustic pattern displaces
   further than the r ~ 1.4 kernel radius, so distant structure produces
   no gradient pull — the classic narrow-basin problem of differentiable
   rendering.
2. KERNEL-RADIUS ANNEALING widens the basin: early stages render target
   AND loss with a LARGE init_r2 (heavily blurred caustics -> gradients
   see far), later stages shrink r2 back to the reference's 2.0 to
   sharpen.  This is SPPM's own progressive-radius idea applied to the
   LOSS level.  Each stage is exact CRN (target re-rendered at that
   stage's r2 with the same key the loss uses).

Writes docs/INVERSE_CTRL_EPA.json + docs/inverse_ctrl_epa.png.
Reference for the differentiated deposit line: raytracer/Raytracer.h:156;
control points: raytracer/Bezier.h:188-239.
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
    ap.add_argument("--stages", default="32,8,2",
                    help="comma list of init_r2 values, coarse to fine")
    ap.add_argument("--steps-per-stage", type=int, default=150)
    ap.add_argument("--sigma", type=float, default=0.05)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--platform", default=None)
    args = ap.parse_args()

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    from raytrace3_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()

    import jax.numpy as jnp
    import numpy as np
    import optax

    from raytrace3_tpu.backends import select_backends
    from raytrace3_tpu.diff.train import extract_params, make_render_fn
    from raytrace3_tpu.geometry.bezier import bernstein
    from raytrace3_tpu.render.deposit import deposit_bruteforce_epa
    from raytrace3_tpu.render.driver import build_scene
    from raytrace3_tpu.utils.config import RenderConfig

    rng = np.random.default_rng(args.seed)

    base_cfg = RenderConfig(
        scene="bezier_patch", width=48, height=48, rounds=2,
        photons_per_round=8192, max_depth=6, atlas_res=16,
        bezier_compact_frac=1.0,
    )
    scene = build_scene(base_cfg)
    scene = scene.replace(
        light_pos=jnp.asarray([[10.0, 18.0, 108.0]], jnp.float32))
    camera_pose = ((8.0, 8.0, 128.0), (16.0, 6.6, 116.0))

    _, newton_fn = select_backends(base_cfg, scene)

    true_params = extract_params(scene)
    key = jax.random.key(args.seed + 1)

    noise = rng.normal(0.0, args.sigma,
                       np.asarray(true_params["ctrl"]).shape)
    params = dict(true_params,
                  ctrl=true_params["ctrl"] + jnp.asarray(
                      noise.astype(np.float32)))

    # surface metric (HIGHEST per the round-4 advisory)
    gu = jnp.linspace(0.0, 1.0, 24)
    bv = bernstein(gu)

    @jax.jit
    def _surf(c):
        return jnp.einsum("ia,jb,pabc->pijc", bv, bv, c,
                          precision=jax.lax.Precision.HIGHEST)

    s_true = _surf(true_params["ctrl"])

    def surface_err(p):
        d = _surf(p["ctrl"]) - s_true
        return float(jnp.sqrt(jnp.sum(d * d, -1)).mean())

    s0 = surface_err(params)
    p0 = float(jnp.abs(params["ctrl"] - true_params["ctrl"]).mean())
    stages = [float(s) for s in args.stages.split(",")]
    curves = []
    t0 = time.time()
    for r2 in stages:
        cfg = base_cfg.replace(init_r2=r2)
        render = make_render_fn(scene, cfg, camera_pose=camera_pose,
                                newton_fn=newton_fn,
                                deposit_fn=deposit_bruteforce_epa)
        target = jax.jit(render)(true_params, key)
        target = jax.block_until_ready(target)
        opt = optax.adam(optax.cosine_decay_schedule(
            args.lr, args.steps_per_stage, alpha=0.05))
        opt_state = opt.init(params)

        @jax.jit
        def step(p, o):
            def loss_fn(p):
                img = render(p, key)
                return jnp.mean((img - target) ** 2)

            loss, grads = jax.value_and_grad(loss_fn)(p)
            upd, o = opt.update(grads, o, p)
            return optax.apply_updates(p, upd), o, loss

        for i in range(args.steps_per_stage):
            params, opt_state, loss = step(params, opt_state)
            if i % 10 == 0 or i == args.steps_per_stage - 1:
                se = surface_err(params)
                pe = float(jnp.abs(params["ctrl"]
                                   - true_params["ctrl"]).mean())
                curves.append([r2, i, float(loss), pe, se])
                print(f"anneal r2={r2} step {i}: loss {float(loss):.3e} "
                      f"|dctrl| {pe:.4f} surface {se:.4f}",
                      file=sys.stderr, flush=True)
    dt = time.time() - t0

    sf = surface_err(params)
    pf = float(jnp.abs(params["ctrl"] - true_params["ctrl"]).mean())
    record = {
        "experiment": "ctrl (smooth kernel + radius anneal)",
        "deposit_kernel": "epanechnikov",
        "crn": True,
        "stages_init_r2": stages,
        "steps_per_stage": args.steps_per_stage,
        "sigma": args.sigma, "lr": args.lr,
        "device": {"platform": jax.devices()[0].platform,
                   "kind": jax.devices()[0].device_kind},
        "initial_param_err": round(p0, 5),
        "final_param_err": round(pf, 5),
        "initial_surface_err": round(s0, 5),
        "final_surface_err": round(sf, 5),
        "surface_err_reduction": round(s0 / max(sf, 1e-9), 2),
        "seconds": dt,
        "curve": [[r2, i, round(l, 8), round(pe, 6), round(se, 6)]
                  for r2, i, l, pe, se in curves],
        "pass": bool(sf < 0.25 * s0),
    }
    out = os.path.join(REPO, "docs", "INVERSE_CTRL_ANNEAL.json")
    with open(out, "w") as f:
        json.dump(record, f, indent=2)
        f.write("\n")

    try:
        from raytrace3_tpu.render.sppm import tonemap
        from raytrace3_tpu.utils.image import save_png

        cfg2 = base_cfg.replace(init_r2=stages[-1])
        render = make_render_fn(scene, cfg2, camera_pose=camera_pose,
                                newton_fn=newton_fn,
                                deposit_fn=deposit_bruteforce_epa)
        img_t = np.asarray(jax.jit(render)(true_params, key))
        img_b = np.asarray(jax.jit(render)(
            dict(true_params, ctrl=true_params["ctrl"] + jnp.asarray(
                noise.astype(np.float32))), key))
        img_r = np.asarray(jax.jit(render)(params, key))
        h = cfg2.height
        trip = np.concatenate([a.reshape(h, -1, 3)
                               for a in (img_t, img_b, img_r)], axis=1)
        save_png(os.path.join(REPO, "docs", "inverse_ctrl_epa.png"),
                 np.asarray(tonemap(jnp.asarray(trip))), tonemapped=True)
    except Exception as e:
        print(f"PNG skipped ({e})", file=sys.stderr)

    print(json.dumps({k: v for k, v in record.items() if k != "curve"},
                     indent=2))
    return 0 if record["pass"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
