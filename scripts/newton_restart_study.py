#!/usr/bin/env python
"""Newton restart-budget certification study.

The reference brute-forces ray-Bezier intersection with 50 RANDOM restarts
x 10 Newton iterations per (ray, patch) (raytracer/Bezier.h:6 NEWTON_RAND,
Bezier.h:115-159); our solver (geometry/bezier.py) uses a STRATIFIED
(gu x gv) start grid per patch.  This study measures per-ray root
agreement of starts in {4, 8, 16, 32} against a 64-start (8x8 stratified)
oracle on three adversarial ray populations:

  * eye:     the actual 512^2 camera rays from the reference pose;
  * photon:  light-emitted rays re-aimed at the teapot AABB (caustic
             feeders: what the photon pass actually traces);
  * grazing: rays aimed tangentially at random surface points from far
             away — maximum multi-root / silhouette stress.

Metrics per (population, restarts): of the oracle's hits, the fraction the
candidate MISSES entirely (miss), and the fraction where both hit but pick
different roots (t differs > 1e-3 relative: root_diff).  false_hit counts
candidate hits where the 64-restart oracle found nothing (a looser-grid
restart landing in a root the oracle's residual test also accepts would be
benign; a hit the oracle cannot reproduce at ANY of 64 starts is suspect).

Writes docs/NEWTON_RESTARTS.json.  Usage:
  python scripts/newton_restart_study.py     # RT3_PLATFORM=cpu for the CPU
"""

from __future__ import annotations

import json
import os
import sys
from functools import partial

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax
import jax.numpy as jnp
import numpy as np


def main() -> int:
    from raytrace3_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    plat = os.environ.get("RT3_PLATFORM")
    if plat:
        jax.config.update("jax_platforms", plat)

    from raytrace3_tpu.geometry.bezier import bernstein, solve_winner
    from raytrace3_tpu.render.camera import emit_rays, look_at
    from raytrace3_tpu.render.driver import build_scene
    from raytrace3_tpu.utils.config import RenderConfig

    cfg = RenderConfig(scene="full", width=512, height=512, atlas_res=16)
    scene = build_scene(cfg)
    ctrl = scene.bezier.ctrl                     # (32, 4, 4, 3)
    rng = np.random.default_rng(0)

    # --- surface points for aiming (dense stratified u, v per patch) ---
    gu = jnp.linspace(0.02, 0.98, 8)
    bv = bernstein(gu)                           # (8, 4)
    surf = jnp.einsum("ia,jb,pabc->pijc", bv, bv, ctrl,
                      precision=jax.lax.Precision.HIGHEST)
    surf = np.asarray(surf).reshape(-1, 3)       # (32*64, 3)
    lo = np.asarray(ctrl).reshape(-1, 3).min(0)
    hi = np.asarray(ctrl).reshape(-1, 3).max(0)
    center, half = (lo + hi) / 2, (hi - lo) / 2

    N = int(os.environ.get("RT3_STUDY_N", "262144"))

    # population 1: the real camera rays (reference pose, Camera.h:32-54)
    base = np.array([50.0, 35.0, 230.0])
    look = base + np.array([0.0, 0.042612, -1.0])
    cam = look_at(jnp.asarray(base, jnp.float32),
                  jnp.asarray(look, jnp.float32), 512, 512)
    org_eye, dir_eye = (np.asarray(a) for a in emit_rays(cam))

    # population 2: photon-like — from the light sphere, aimed at random
    # AABB-interior points (what survives the photon pass's AABB gate)
    light = np.array([50.0, 70.0, 110.0])
    o2 = light + rng.normal(size=(N, 3)) * 2.0
    tgt = center + (rng.uniform(-1, 1, (N, 3))) * half
    d2 = tgt - o2
    d2 /= np.linalg.norm(d2, axis=1, keepdims=True)

    # population 3: grazing — distant origins, directions at a random
    # surface point PLUS a tangential offset of ~the patch scale
    sp = surf[rng.integers(0, surf.shape[0], N)]
    o3 = center + rng.normal(size=(N, 3)) * 1.0
    o3 += (rng.uniform(size=(N, 1)) * 60 + 30) * _unit(rng, N)
    off = rng.normal(size=(N, 3)) * np.array([3.0, 1.0, 3.0])
    d3 = (sp + off) - o3
    d3 /= np.linalg.norm(d3, axis=1, keepdims=True)

    pops = {
        "eye": (org_eye.astype(np.float32), dir_eye.astype(np.float32)),
        "photon": (o2.astype(np.float32), d2.astype(np.float32)),
        "grazing": (o3.astype(np.float32), d3.astype(np.float32)),
    }

    oracle_r = 64
    candidates = [4, 8, 16, 32]
    def solver(r):
        one = jax.jit(partial(solve_winner, iters=10, restarts=r))

        def batched(o, d, c, batch=8192):
            outs = [one(o[i:i + batch], d[i:i + batch], c)
                    for i in range(0, o.shape[0], batch)]
            return tuple(jnp.concatenate(x) for x in zip(*outs))

        return batched

    solvers = {r: solver(r) for r in candidates + [oracle_r]}

    dev = jax.devices()[0]
    record = {"oracle_restarts": oracle_r, "iters": 10,
              "n_rays": {k: int(v[0].shape[0]) for k, v in pops.items()},
              "device": {"platform": dev.platform, "kind": dev.device_kind},
              "pops": {}}
    for pname, (o, d) in pops.items():
        o_j, d_j = jnp.asarray(o), jnp.asarray(d)
        t64, _, _, p64, h64 = (np.asarray(x) for x in
                               solvers[oracle_r](o_j, d_j, ctrl))
        row = {"oracle_hits": int(h64.sum())}
        for r in candidates:
            t, _, _, pid, h = (np.asarray(x) for x in
                               solvers[r](o_j, d_j, ctrl))
            both = h64 & h
            miss = h64 & ~h
            false_hit = h & ~h64
            tdiff = np.zeros_like(t64)
            tdiff[both] = np.abs(t[both] - t64[both]) / np.maximum(
                t64[both], 1e-6)
            root_diff = both & (tdiff > 1e-3)
            oh = max(int(h64.sum()), 1)
            row[str(r)] = {
                "miss": int(miss.sum()), "miss_rate": float(miss.sum() / oh),
                "root_diff": int(root_diff.sum()),
                "root_diff_rate": float(root_diff.sum() / oh),
                "false_hit": int(false_hit.sum()),
                "max_tdiff_rel": float(tdiff.max()) if both.any() else 0.0,
            }
        record["pops"][pname] = row
        print(json.dumps({pname: row}), flush=True)

    out = os.path.join(REPO, "docs", "NEWTON_RESTARTS.json")
    with open(out, "w") as f:
        json.dump(record, f, indent=1)
    print(f"wrote {out}", file=sys.stderr)
    return 0


def _unit(rng, n):
    v = rng.normal(size=(n, 3))
    return v / np.linalg.norm(v, axis=1, keepdims=True)


if __name__ == "__main__":
    raise SystemExit(main())
