#!/usr/bin/env python
"""Cross-validate the JAX renderer against the independent C++ implementation
of the reference algorithm (native/baseline_sppm.cpp) on the FULL scene —
mirror + glass spheres, mirror back wall, 32-patch Bezier teapot caustics.

This proves the headline forward-parity claim (BASELINE.md north star,
VERDICT round 1 missing item 1): the two implementations share no code, no
RNG, and no intermediate layout; they only estimate the same integral
(the reference SPPM estimator, raytracer/Raytracer.h:117-209,281-357, with
its quirks preserved: biased roulette, any-zero-channel lobe predicates,
fixed radius as executed).  Agreement of block-pooled LINEAR radiance is
therefore evidence the specular/refractive transport and the Newton patch
intersection are right in both.

Usage:
  python scripts/crossval.py [--res 128] [--photons 2097152] \
      [--platform cpu] [--block 16] [--out docs/CROSSVAL.json]

On the GPU the JAX side uses the banded Triton deposit; on the CPU
(``--platform cpu``) the bruteforce oracle, which is slow at this budget.  The C++ side is built with g++ and
runs on the host's cores.

Writes the JSON verdict + docs/crossval_{jax,cpp}.png side-by-side renders.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
#: C++ image dumps and atlas files (listed in .gitignore).
BUILD = os.path.join(REPO, "build")


def dump_atlas(scene, path: str) -> None:
    """Write the scene's texture atlas for the C++ side (int32 n; per tex
    int32 H, W; H*W*3 float32) — the SAME procedural texels the JAX render
    samples, so the textured crossval compares transport, not assets."""
    import numpy as np

    atlas = np.asarray(scene.atlas, np.float32)          # (T, H, W, 3)
    with open(path, "wb") as f:
        f.write(np.asarray([atlas.shape[0]], np.int32).tobytes())
        for t in range(atlas.shape[0]):
            f.write(np.asarray(atlas.shape[1:3], np.int32).tobytes())
            f.write(np.ascontiguousarray(atlas[t]).tobytes())


def run_cpp(res: int, photons: int, dump: str, texbin: str | None = None,
            onetime: int = 100, update_mode: str = "reference") -> dict:
    src = os.path.join(REPO, "native", "baseline_sppm.cpp")
    exe = os.path.join(REPO, "native", "baseline_sppm")
    if not os.path.exists(exe) or os.path.getmtime(exe) < os.path.getmtime(src):
        subprocess.run(["g++", "-O3", "-march=native", "-fopenmp",
                        "-std=c++17", src, "-o", exe], check=True)
    rounds = max(photons // onetime, 1)
    # live-sppm runs a single chain (the radius trajectory is sequential);
    # reference mode keeps the reference's per-thread independent pass split
    threads = 1 if update_mode == "sppm" else (os.cpu_count() or 1)
    out = subprocess.run(
        [exe, os.path.join(REPO, "assets", "teapot.bpt"), str(res),
         str(rounds), str(threads), dump, texbin or "-", str(onetime),
         "sppm" if update_mode == "sppm" else "ref"],
        check=True, capture_output=True, text=True, timeout=7200,
    ).stdout.strip()
    return json.loads(out.splitlines()[-1])


def run_jax(res: int, photons: int, platform: str | None, seed: int = 0,
            scene_name: str = "full_flat", update_mode: str = "reference",
            per_round_cap: int = 131072, atlas_res: int = 16,
            texdump: str | None = None, newton_restarts: int = 8):
    import jax

    if platform:
        jax.config.update("jax_platforms", platform)
    import jax.numpy as jnp
    import numpy as np

    from raytrace3_tpu.backends import select_backends
    from raytrace3_tpu.render.camera import emit_rays, look_at
    from raytrace3_tpu.render.driver import build_scene
    from raytrace3_tpu.render.sppm import render_pass
    from raytrace3_tpu.utils.config import RenderConfig

    per_round = min(photons, per_round_cap)
    rounds = max(photons // per_round, 1)
    cfg = RenderConfig(
        scene=scene_name, width=res, height=res, rounds=rounds,
        photons_per_round=per_round, max_depth=13, atlas_res=atlas_res,
        update_mode=update_mode,
        bezier_compact_frac=0.12, bezier_compact_frac_photon=0.06,
        hitpoint_factor=1.5, newton_restarts=newton_restarts,
    )
    scene = build_scene(cfg)
    if texdump:
        dump_atlas(scene, texdump)
    cam = look_at(jnp.asarray([50.0, 35.0, 230.0], jnp.float32),
                  jnp.asarray([50.0, 35.042612, 229.0], jnp.float32),
                  res, res)
    org, dirs = emit_rays(cam)
    photon_scene = scene.replace(
        bezier_compact_frac=cfg.bezier_compact_frac_photon)

    deposit_fn, newton_fn = select_backends(cfg, scene)
    fn = jax.jit(lambda k: render_pass(
        scene, org, dirs, k,
        hitpoint_capacity=cfg.hitpoint_capacity,
        n_rounds=rounds, photons_per_round=per_round,
        max_depth=cfg.max_depth, update_mode=update_mode,
        deposit_fn=deposit_fn, newton_fn=newton_fn,
        photon_scene=photon_scene,
    ))
    t0 = time.perf_counter()
    img, stats = fn(jax.random.key(seed))
    img = np.asarray(jax.device_get(img)).reshape(res, res, 3)
    dt = time.perf_counter() - t0
    stats = {k: float(jax.device_get(v)) for k, v in stats.items()}
    assert stats["deposits_dropped"] == 0, stats
    return img, stats, dt, rounds * per_round


def pool(a, b: int):
    h, w, _ = a.shape
    return a.reshape(h // b, b, w // b, b, 3).mean((1, 3))


def tonemap(x):
    import numpy as np
    return np.power(1.0 - np.exp(-np.maximum(x, 0.0)), 1.0 / 2.2)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--res", type=int, default=128)
    ap.add_argument("--photons", type=int, default=2097152)
    ap.add_argument("--platform", default=None)
    ap.add_argument("--block", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--textures", action="store_true",
                    help="crossval the TEXTURED full scene: the JAX atlas "
                         "is dumped for the C++ side, which samples it "
                         "through the same UV quirk rules (VERDICT item 6)")
    ap.add_argument("--update-mode", choices=["reference", "sppm"],
                    default="reference",
                    help="sppm = LIVE textbook radius shrink on BOTH sides "
                         "with matched round batching (single C++ chain)")
    ap.add_argument("--newton-restarts", type=int, default=8,
                    help="Newton starts per ray-patch pair")
    ap.add_argument("--out", default=None)
    ap.add_argument("--skip-cpp", action="store_true",
                    help="reuse an existing dump from a previous run")
    args = ap.parse_args()

    import numpy as np

    # Force the platform BEFORE any scene build: dump_atlas(get_scene(...))
    # below creates jnp arrays, and array creation initialises the default
    # backend.
    if args.platform:
        import jax

        jax.config.update("jax_platforms", args.platform)

    scene_name = "full" if args.textures else "full_flat"
    atlas_res = 64 if args.textures else 16
    tag = ("_tex" if args.textures else "") + (
        "_sppm" if args.update_mode == "sppm" else "")
    if args.out is None:
        args.out = os.path.join(REPO, "docs", f"CROSSVAL{tag.upper()}.json")
    per_round_cap = 65536 if args.update_mode == "sppm" else 131072
    onetime = per_round_cap if args.update_mode == "sppm" else 100

    os.makedirs(BUILD, exist_ok=True)
    texbin = None
    if args.textures:
        # Dump the EXACT atlas the JAX render will sample (deterministic
        # procedural textures at this atlas_res).
        texbin = os.path.join(BUILD, f"crossval_atlas_{atlas_res}.bin")
        from raytrace3_tpu.scenes import get_scene

        dump_atlas(get_scene(scene_name, atlas_res=atlas_res), texbin)

    dump = os.path.join(BUILD, f"crossval_cpp_{args.res}{tag}.bin")
    if not (args.skip_cpp and os.path.exists(dump)):
        print(f"crossval: C++ side ({args.photons} photons @ {args.res}^2, "
              f"{scene_name}, {args.update_mode})...",
              file=sys.stderr, flush=True)
        cpp_stats = run_cpp(args.res, args.photons, dump, texbin=texbin,
                            onetime=onetime, update_mode=args.update_mode)
        print(f"crossval: C++ {cpp_stats}", file=sys.stderr, flush=True)
    else:
        cpp_stats = {"reused": True}
    cpp = np.fromfile(dump, dtype=np.float32).reshape(args.res, args.res, 3)

    print("crossval: JAX side ...", file=sys.stderr, flush=True)
    ours, stats, dt, emitted = run_jax(
        args.res, args.photons, args.platform, args.seed,
        scene_name=scene_name, update_mode=args.update_mode,
        per_round_cap=per_round_cap, atlas_res=atlas_res,
        newton_restarts=args.newton_restarts)
    print(f"crossval: JAX pass {dt:.1f}s, {stats}", file=sys.stderr, flush=True)

    po, pc = pool(ours, args.block), pool(cpp, args.block)
    lum_c = pc.mean(-1)
    mask = lum_c > 0.05            # skip near-black blocks (MC noise floor)
    rel = np.abs(po - pc)[mask] / (pc[mask] + 0.05)

    # PSNR over the tone-mapped [0,1] images (what a viewer compares)
    tm_o, tm_c = tonemap(ours), tonemap(cpp)
    mse = float(np.mean((tm_o - tm_c) ** 2))
    psnr = 10.0 * np.log10(1.0 / mse) if mse > 0 else float("inf")

    from raytrace3_tpu.utils.image import save_png

    os.makedirs(os.path.join(REPO, "docs"), exist_ok=True)
    save_png(os.path.join(REPO, "docs", f"crossval_jax{tag}.png"), ours)
    save_png(os.path.join(REPO, "docs", f"crossval_cpp{tag}.png"), cpp)

    import jax

    dev = jax.devices()[0]
    record = {
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "deposit": "banded" if dev.platform == "gpu" else "bruteforce",
        "newton_restarts": args.newton_restarts,
        "scene": f"{scene_name} (mirror+glass spheres, mirror wall, teapot)"
                 + (" TEXTURED via shared atlas dump" if args.textures else ""),
        "update_mode": args.update_mode,
        "res": args.res,
        "photons_each": int(emitted),
        "block": args.block,
        "blocks_compared": int(mask.sum()),
        "blocks_total": int(mask.size),
        "rel_err_mean": round(float(rel.mean()), 4),
        "rel_err_p95": round(float(np.percentile(rel, 95)), 4),
        "rel_err_max": round(float(rel.max()), 4),
        "psnr_tonemapped_db": round(psnr, 2),
        "jax_stats": {k: round(v, 2) for k, v in stats.items()},
        "cpp_stats": cpp_stats,
        "pass": bool(rel.mean() < 0.10 and psnr > 25.0),
    }
    with open(args.out, "w") as f:
        json.dump(record, f, indent=2)
        f.write("\n")
    print(json.dumps(record, indent=2))
    return 0 if record["pass"] else 1


if __name__ == "__main__":
    main_rc = main()
    raise SystemExit(main_rc)
