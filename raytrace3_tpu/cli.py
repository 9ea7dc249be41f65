"""Command-line renderer.

Reference: ``main()`` (raytracer/main.cpp:19-42) — a hard-coded entry point
with zero flags that renders one scene forever.  Here: named scenes and
presets, every constant a flag, checkpoint/resume, metrics.
"""

from __future__ import annotations

import argparse
import logging


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="rt3", description="Differentiable SPPM renderer in JAX"
    )
    p.add_argument("--preset", default=None,
                   help="named config preset (cornell128/specular256/"
                        "bezier256/teapot512/sharded10m/bench512/"
                        "reference1024)")
    p.add_argument("--scene", default=None,
                   help="scene name (overrides preset scene)")
    p.add_argument("--res", type=int, default=None, help="square resolution")
    p.add_argument("--passes", type=int, default=None)
    p.add_argument("--rounds", type=int, default=None)
    p.add_argument("--photons", type=int, default=None,
                   help="photons per round per light")
    p.add_argument("--depth", type=int, default=None, help="max trace depth")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--update-mode", choices=["sppm", "reference"], default=None)
    p.add_argument("--hp-sharded", action="store_true",
                   help="with --sharded: shard HIT POINTS over the mesh "
                        "(ring photon exchange) instead of replicating them")
    p.add_argument("--regen", action="store_true",
                   help="refill dead photon lanes every segment "
                        "(more photons/s at identical expectation)")
    p.add_argument("--out", default=None, help="output PNG path")
    p.add_argument("--checkpoint", default=None, help="checkpoint file path")
    p.add_argument("--checkpoint-every", type=int, default=None)
    p.add_argument("--preview-every", type=int, default=1,
                   help="write the running-average PNG every N passes "
                        "(default 1 = the reference's per-pass progressive "
                        "dump, Raytracer.h:472-474; 0 disables — use for "
                        "benchmarking, per-pass host I/O breaks the async "
                        "dispatch pipeline)")
    p.add_argument("--metrics-jsonl", default=None)
    p.add_argument("--profile-dir", default=None,
                   help="write a jax.profiler trace of one pass here")
    p.add_argument("--platform", default=None,
                   help="force a JAX platform (cpu for tests and small "
                        "renders; default: the GPU)")
    p.add_argument("--sharded", action="store_true",
                   help="shard passes/photons over all local devices")
    p.add_argument("-v", "--verbose", action="store_true")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.INFO if args.verbose else logging.WARNING,
        format="%(asctime)s %(name)s %(message)s",
    )

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)

    from .utils.config import RenderConfig, get_config

    cfg = get_config(args.preset) if args.preset else RenderConfig()
    over = {}
    if args.scene: over["scene"] = args.scene
    if args.res: over.update(width=args.res, height=args.res)
    if args.passes is not None: over["passes"] = args.passes
    if args.rounds is not None: over["rounds"] = args.rounds
    if args.photons is not None: over["photons_per_round"] = args.photons
    if args.depth is not None: over["max_depth"] = args.depth
    if args.seed is not None: over["seed"] = args.seed
    if args.update_mode: over["update_mode"] = args.update_mode
    if args.regen: over["photon_regen"] = True
    if args.out: over["out"] = args.out
    if args.checkpoint_every is not None:
        over["checkpoint_every"] = args.checkpoint_every
    cfg = cfg.replace(**over)

    from .backends import select_backends
    from .render import driver
    from .utils.cache import enable_compile_cache
    from .utils.image import save_png

    enable_compile_cache()
    scene = driver.build_scene(cfg)
    deposit_fn, newton_fn = select_backends(cfg, scene)

    if args.sharded:
        from .parallel.shard import render_sharded
        img, metrics = render_sharded(cfg, newton_fn=newton_fn,
                                      deposit_fn=deposit_fn,
                                      hp_sharded=args.hp_sharded)
    else:
        img, metrics = driver.render(
            cfg,
            scene=scene,
            checkpoint_path=args.checkpoint,
            preview_every=args.preview_every,
            metrics_jsonl=args.metrics_jsonl,
            newton_fn=newton_fn,
            deposit_fn=deposit_fn,
            profile_dir=args.profile_dir,
        )
    save_png(cfg.out, img)
    m = metrics.get("meter", {})
    print(
        f"wrote {cfg.out}  passes={m.get('passes')}  "
        f"photons/s={m.get('photons_per_s', 0):.3g}  "
        f"Mrays/s={m.get('mrays_per_s', 0):.2f}"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
