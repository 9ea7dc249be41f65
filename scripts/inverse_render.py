#!/usr/bin/env python
"""Inverse rendering: recover perturbed scene parameters from a rendered
target by gradient descent through the full SPPM pass.

The README's inverse-rendering claim needs an artifact, not just a smoke
test.  Two experiments:

  * ``albedo`` — the diffuse Cornell scene at 128^2: the diffuse albedo
    table (reference Material.diff, Scene.h:100-113) is perturbed by
    per-channel factors in [0.55, 1.45] and recovered with Adam.  The
    deposit backward is the bruteforce custom VJP (diff/vjp.py), the
    training step's default.
  * ``ctrl`` — the curved-teapot-patch scene (same as scripts/gradcheck.py)
    at 48^2: Bezier control points are perturbed by Gaussian noise and
    recovered; gradients flow through the Newton intersection via the
    implicit-function-theorem custom_vjp (geometry/bezier.py winner_root —
    the differentiable replacement of raytracer/Bezier.h:112-159).

Common-random-numbers setup: the target is rendered at the TRUE parameters
with the SAME key the loss uses, so the loss is deterministic with minimum
exactly at the truth — convergence isolates gradient correctness from
Monte-Carlo noise.

Writes docs/INVERSE_<exp>.json (loss + parameter-error curves) and a
side-by-side PNG.  Usage:
  python scripts/inverse_render.py --exp albedo [--steps 200] \
      [--platform cpu]
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
    ap.add_argument("--exp", choices=["albedo", "ctrl"], default="albedo")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--platform", default=None)
    ap.add_argument("--seed", type=int, default=0)
    # The deposit density kernel (VERDICT round 4 item 4): "box" is the
    # reference-parity estimator whose a.e. geometry gradients omit the
    # boundary term (the measured negative result in docs/INVERSE_CTRL.json);
    # "epanechnikov" is the smooth opt-in whose flux weight is continuous at
    # the radius boundary, making the a.e. derivative the TRUE derivative —
    # gradients then flow into deposit/hit positions via plain AD through
    # the chunked bruteforce (render/deposit.py).
    ap.add_argument("--kernel", choices=["box", "epanechnikov"],
                    default="box")
    # ctrl-experiment knobs (the recovery lives or dies on the SNR between
    # the geometry signal and the stochastic-loss variance floor):
    ap.add_argument("--n-avg", type=int, default=0,
                    help="renders averaged per step (0 = experiment default)")
    ap.add_argument("--sigma", type=float, default=0.05,
                    help="ctrl perturbation stddev")
    ap.add_argument("--lr", type=float, default=0.0,
                    help="override learning rate (0 = experiment default)")
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
    from raytrace3_tpu.diff.vjp import deposit_bruteforce_vjp
    from raytrace3_tpu.render.driver import build_scene
    from raytrace3_tpu.utils.config import RenderConfig

    rng = np.random.default_rng(args.seed)

    if args.exp == "albedo":
        # cornell_diffuse: every material is untextured diffuse, so every
        # albedo coordinate drives the image directly and the inverse
        # problem is well-conditioned.  (The textured FULL scene was tried
        # first: its loss minimises 380x but the basin is DEGENERATE at
        # this budget — textured planes take their colour from the atlas,
        # so several diff rows move the image below the 2.7e-5 loss floor
        # and gradient descent converges to a different, equally-consistent
        # table.  Gradient correctness is what the artifact certifies;
        # conditioning is the scene's job.)
        cfg = RenderConfig(
            scene="cornell_diffuse", width=128, height=128, rounds=4,
            photons_per_round=16384, max_depth=13, atlas_res=16,
            hitpoint_factor=1.5,
        )
        scene = build_scene(cfg)
        camera_pose = None
        lr, key_name = 2e-2, "diff"

        def perturb(p):
            true = np.asarray(p["diff"])
            fac = rng.uniform(0.55, 1.45, true.shape).astype(np.float32)
            return dict(p, diff=jnp.asarray(np.clip(true * fac, 0.0, 1.0)))
    else:
        cfg = RenderConfig(
            scene="bezier_patch", width=48, height=48, rounds=2,
            photons_per_round=8192, max_depth=6, atlas_res=16,
            bezier_compact_frac=1.0,
        )
        scene = build_scene(cfg)
        scene = scene.replace(
            light_pos=jnp.asarray([[10.0, 18.0, 108.0]], jnp.float32))
        camera_pose = ((8.0, 8.0, 128.0), (16.0, 6.6, 116.0))
        lr, key_name = 1e-3, "ctrl"

        def perturb(p):
            # sigma 0.05 (~0.6% of the patch extent), recovered under the
            # AVERAGED-STOCHASTIC loss (see below).  What was measured on
            # the way here, all with fixed-key CRN: sigma 0.25 leaves the
            # caustic structure itself displaced (loss down only 1.5x,
            # parameters immobile); 0.08 descends 2.7x into a NEARBY LOCAL
            # basin (surface error drifts up while the loss falls); 0.02
            # and a res-16 sparse variant never descend at all — the
            # realized box-kernel estimator is a STAIRCASE in geometry and
            # the a.e. gradient points along the treads.
            true = np.asarray(p["ctrl"])
            noise = rng.normal(0.0, args.sigma, true.shape).astype(np.float32)
            return dict(p, ctrl=jnp.asarray(true + noise))

    _, newton_fn = select_backends(cfg, scene)
    if args.kernel == "epanechnikov":
        # Smooth kernel: plain AD through the chunked bruteforce — position
        # and radius cotangents are real here (the box-kernel VJP's
        # position cotangents are the a.e.-zero derivative).
        from raytrace3_tpu.render.deposit import deposit_bruteforce_epa
        deposit_fn = deposit_bruteforce_epa
        dep_name = "bruteforce(epanechnikov, plain AD)"
    else:
        deposit_fn = deposit_bruteforce_vjp
        dep_name = "bruteforce(box, custom VJP)"
    render = make_render_fn(scene, cfg, camera_pose=camera_pose,
                            newton_fn=newton_fn, deposit_fn=deposit_fn)

    true_params = extract_params(scene)
    key = jax.random.key(args.seed + 1)
    print(f"inverse[{args.exp}]: rendering target "
          f"({cfg.width}^2, platform={jax.devices()[0].platform})...",
          file=sys.stderr, flush=True)
    # ctrl runs AVERAGED-STOCHASTIC: with a fixed key the realized SPPM
    # estimator is a staircase in geometry, so fresh photon keys each step
    # make the jumps zero-mean around the smooth EXPECTED loss (standard
    # stochastic differentiable-MC practice) — but one key per step left
    # the per-step variance floor ABOVE the sigma-0.05 geometry signal
    # (measured: floor 0.13 at 16K photons, 0.031 at 131K, signal ~0.03).
    # Averaging n_avg vmapped renders per step divides the floor by n_avg
    # and puts it under the signal; the target is a 32-key average.
    # albedo keeps common random numbers (its estimator is smooth in
    # albedo, and CRN makes recovery exact).
    n_avg = (8 if args.exp == "ctrl" else 1)
    if args.n_avg:
        n_avg = args.n_avg
    if args.lr > 0.0:
        lr = args.lr
    if n_avg > 1:
        def render_mean(p, ks):
            # scan, not vmap, and checkpoint each render: the backward
            # otherwise saves EVERY averaged render's walk residuals at
            # once; rematerialising holds one render's residuals at a time.
            def body(acc, k):
                return acc + jax.checkpoint(render)(p, k), None

            acc, _ = jax.lax.scan(
                body, jnp.zeros((cfg.n_pixels, 3), jnp.float32), ks)
            return acc / ks.shape[0]

        tgt_ks = jnp.stack([jax.random.fold_in(key, 1000 + j)
                            for j in range(32)])
        target = jax.jit(render_mean)(true_params, tgt_ks)
    else:
        render_mean = None
        target = jax.jit(render)(true_params, key)
    target = jax.block_until_ready(target)

    params = perturb(true_params)
    p0_err = float(jnp.abs(params[key_name] - true_params[key_name]).mean())

    # Cosine-decayed Adam: the loss at the truth is EXACTLY zero (common
    # random numbers), so the only thing between the plateau and the basin
    # floor is the constant-lr oscillation amplitude — the first albedo run
    # bounced at loss ~3.5e-5 / |ddiff| ~0.09 for 100 steps with no drift.
    opt = optax.adam(optax.cosine_decay_schedule(lr, args.steps, alpha=0.02))
    opt_state = opt.init(params)

    # Identifiability mask: coordinates with EXACTLY zero gradient at the
    # start cannot affect the image (e.g. the diffuse-albedo rows of the
    # purely specular mirror/glass materials multiply lobes whose branch
    # power is 0 — no estimator can recover them).  Recovery is scored on
    # the identifiable set; the unrestricted error is recorded alongside.
    g0 = jax.jit(jax.grad(lambda p: jnp.mean((render(p, key) - target) ** 2))
                 )(params)[key_name]
    ident = np.asarray(jnp.abs(g0) > 0.0)
    n_ident = int(ident.sum())

    def param_err(p):
        d = np.abs(np.asarray(p[key_name] - true_params[key_name]))
        return float(d.mean()), float(d[ident].mean())

    _, p0_err_id = param_err(params)

    # ctrl: ALSO measure the recovered SURFACE, S(u, v) on a dense grid —
    # a bicubic patch has near-null directions (interior control points
    # sliding tangentially move the surface by far less than themselves),
    # so raw parameter error can stall while the geometry the renderer
    # actually sees converges.  Surface distance is the physical target.
    surface_err = None
    if key_name == "ctrl":
        from raytrace3_tpu.geometry.bezier import bernstein

        gu = jnp.linspace(0.0, 1.0, 24)
        bv = bernstein(gu)                                  # (24, 4)

        @jax.jit
        def _surf(c):
            # S(v=gu[i], u=gu[j]) for every patch: (B, 24, 24, 3).
            # HIGHEST is load-bearing: a reduced-precision matmul (bf16,
            # or TF32 on a GPU) rounds ctrl coords (z ~ 116) against a
            # sigma-0.05 signal and distorts the surface metric.
            return jnp.einsum("ia,jb,pabc->pijc", bv, bv, c,
                              precision=jax.lax.Precision.HIGHEST)

        s_true = _surf(true_params["ctrl"])

        def surface_err(p):
            d = _surf(p["ctrl"]) - s_true
            return float(jnp.sqrt(jnp.sum(d * d, -1)).mean())

    s0_err = surface_err(params) if surface_err else None

    @jax.jit
    def step(params, opt_state, k):
        def loss_fn(p):
            if n_avg > 1:
                img = render_mean(p, jax.random.split(k, n_avg))
            else:
                img = render(p, k)
            return jnp.mean((img - target) ** 2)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        if args.exp == "albedo":
            params["diff"] = jnp.clip(params["diff"], 0.0, 1.0)
        return params, opt_state, loss

    losses, errs = [], []
    t0 = time.time()
    for i in range(args.steps):
        ki = jax.random.fold_in(key, i) if n_avg > 1 else key
        params, opt_state, loss = step(params, opt_state, ki)
        if i % 5 == 0 or i == args.steps - 1:
            loss = float(loss)
            err, err_id = param_err(params)
            se = surface_err(params) if surface_err else -1.0
            losses.append([i, loss])
            errs.append([i, err, err_id, se])
            print(f"inverse[{args.exp}] step {i}: loss {loss:.3e} "
                  f"|d{key_name}| {err:.4f} (identifiable {err_id:.4f}"
                  + (f", surface {se:.4f})" if surface_err else ")"),
                  file=sys.stderr, flush=True)
    dt = time.time() - t0

    final_err, final_err_id = errs[-1][1], errs[-1][2]
    final_s_err = errs[-1][3]
    record = {
        "experiment": args.exp,
        "scene": cfg.scene,
        "res": cfg.width,
        "photons_per_step": cfg.rounds * cfg.photons_per_round,
        "steps": args.steps,
        "device": {"platform": jax.devices()[0].platform,
                   "kind": jax.devices()[0].device_kind},
        "deposit_backend": dep_name,
        "deposit_kernel": args.kernel,
        "n_avg": n_avg, "sigma": args.sigma, "lr": lr,
        "identifiable_coords": n_ident,
        "total_coords": int(ident.size),
        "initial_param_err": round(p0_err, 5),
        "final_param_err": round(final_err, 5),
        "initial_param_err_identifiable": round(p0_err_id, 5),
        "final_param_err_identifiable": round(final_err_id, 5),
        "err_reduction_identifiable": round(
            p0_err_id / max(final_err_id, 1e-9), 2),
        "initial_loss": losses[0][1],
        "final_loss": losses[-1][1],
        "loss_reduction": round(losses[0][1] / max(losses[-1][1], 1e-30), 1),
        "seconds": round(dt, 1),
        "step_seconds_mean": round(dt / args.steps, 3),
        "loss_curve": [[i, round(l, 8)] for i, l in losses],
        "param_err_curve": [[i, round(e, 6), round(eid, 6), round(se, 6)]
                            for i, e, eid, se in errs],
        # ctrl is scored on SURFACE distance (the renderer-visible
        # geometry); parameter-space near-null directions are recorded but
        # not the criterion.
        "pass": bool((final_s_err < 0.25 * s0_err) if surface_err
                     else (final_err_id < 0.25 * p0_err_id)),
    }
    if surface_err:
        record["initial_surface_err"] = round(s0_err, 5)
        record["final_surface_err"] = round(final_s_err, 5)
        record["surface_err_reduction"] = round(
            s0_err / max(final_s_err, 1e-9), 2)
    os.makedirs(os.path.join(REPO, "docs"), exist_ok=True)
    # ctrl writes to *_RUN.json: the curated docs/INVERSE_CTRL.json is the
    # measured-escalation summary (gradient path validated, geometry-scale
    # recovery shown NOT to follow from a.e. gradients for this estimator)
    # and must not be clobbered by a rerun of one configuration.
    suffix = ""
    if args.exp == "ctrl":
        suffix = "_EPA" if args.kernel == "epanechnikov" else "_RUN"
    out = os.path.join(REPO, "docs",
                       f"INVERSE_{args.exp.upper()}{suffix}.json")
    with open(out, "w") as f:
        json.dump(record, f, indent=2)
        f.write("\n")

    # side-by-side PNG: target | initial | recovered
    try:
        from raytrace3_tpu.render.sppm import tonemap
        from raytrace3_tpu.utils.image import save_png

        img_rec = np.asarray(jax.jit(render)(params, key))
        img_bad = np.asarray(jax.jit(render)(perturb(true_params), key))
        h = cfg.height
        trip = np.concatenate(
            [np.asarray(target).reshape(h, -1, 3),
             img_bad.reshape(h, -1, 3), img_rec.reshape(h, -1, 3)], axis=1)
        png = f"inverse_{args.exp}" + (
            "_epa" if args.kernel == "epanechnikov" else "") + ".png"
        save_png(os.path.join(REPO, "docs", png),
                 np.asarray(tonemap(jnp.asarray(trip))), tonemapped=True)
    except Exception as e:  # plotting is best-effort
        print(f"inverse: PNG skipped ({e})", file=sys.stderr)

    print(json.dumps({k: v for k, v in record.items()
                      if "curve" not in k}, indent=2))
    return 0 if record["pass"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
