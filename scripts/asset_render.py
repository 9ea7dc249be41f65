#!/usr/bin/env python
"""Render the flagship scene with the reference's REAL texture assets.

Every committed artifact uses procedural texture stand-ins; the reference
ships wall.jpg (marble), timg.jpg (red marble floor) and planet.jpg and
publishes its converged 1024^2 result as 大理石.jpg (its README.md:355).
This script renders the same scene on the ``bench512`` path
(``reference1024`` at --res 1024) with those images loaded via the
``RT3_ASSET_TEXTURES`` override (scenes.py, the cv::imread path of
Element.h:47-59; needs Pillow to decode them) and writes
docs/asset_teapot{res}.png + a metrics JSON.  blue.jpg is missing from the
reference repo (SURVEY quirk #11), so the teapot keeps the flat-blue
stand-in, exactly like the reference as cloned would.

Usage:
  python scripts/asset_render.py --assets <reference>/raytracer \
      [--res 512] [--passes 8]
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
    ap.add_argument("--res", type=int, default=512, choices=(512, 1024))
    ap.add_argument("--passes", type=int, default=8)
    ap.add_argument("--atlas-res", type=int, default=128)
    ap.add_argument("--assets", required=True,
                    help="directory holding the reference's texture images")
    ap.add_argument("--platform", default=None)
    args = ap.parse_args()

    os.environ["RT3_ASSET_TEXTURES"] = args.assets

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)

    import numpy as np

    from raytrace3_tpu.backends import select_backends
    from raytrace3_tpu.render import driver
    from raytrace3_tpu.render.sppm import tonemap
    from raytrace3_tpu.utils.cache import enable_compile_cache
    from raytrace3_tpu.utils.config import get_config
    from raytrace3_tpu.utils.image import save_png

    enable_compile_cache()
    cfg = get_config("bench512" if args.res == 512 else "reference1024",
                     passes=args.passes, atlas_res=args.atlas_res,
                     checkpoint_every=0,
                     out=os.path.join(REPO, "docs",
                                      f"asset_teapot{args.res}.png"))
    scene = driver.build_scene(cfg)
    deposit_fn, newton_fn = select_backends(cfg, scene)

    t0 = time.time()
    img, metrics = driver.render(cfg, scene=scene, deposit_fn=deposit_fn,
                                 newton_fn=newton_fn)
    dt = time.time() - t0
    save_png(cfg.out, np.asarray(tonemap(img)), tonemapped=True)

    dev = jax.devices()[0]
    rec = {
        "what": "full scene with the reference's real textures "
                "(wall.jpg/timg.jpg/planet.jpg via RT3_ASSET_TEXTURES; "
                "blue.jpg absent upstream -> flat blue, quirk #11)",
        "reference_image": "大理石.jpg (reference README.md:355)",
        "res": args.res, "passes": args.passes,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "seconds": dt,
        "meter": metrics.get("meter"),
        "dropped": metrics.get("dropped"),
        "deposits_dropped": metrics.get("deposits_dropped"),
        "out": cfg.out,
    }
    outj = os.path.join(REPO, "docs", f"ASSET_TEAPOT{args.res}.json")
    with open(outj, "w") as f:
        json.dump(rec, f, indent=1, ensure_ascii=False)
    print(json.dumps({k: v for k, v in rec.items() if k != "meter"},
                     ensure_ascii=False))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
