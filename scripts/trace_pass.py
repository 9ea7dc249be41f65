#!/usr/bin/env python
"""Trace one pass of a preset on the GPU; reduce it to device time per
named scope (eye pass, photon rounds, Newton, deposit) and the busiest
kernels (``raytrace3_tpu/utils/trace.py``).

    python scripts/trace_pass.py [--preset bench512] \\
        [--out chiprun_out/trace_pass.json]

XLA runs a pass's kernels inside command buffers (CUDA graphs), which the
profiler reports as one opaque event; this script turns them off
(``--xla_gpu_enable_command_buffer=`` in XLA_FLAGS, recorded in the
output) so every kernel is seen.  It times passes first with the same
flags, so the trace's total can be set against the timed pass.  Needs a
GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
NO_COMMAND_BUFFERS = "--xla_gpu_enable_command_buffer="
SCOPES = ("eye_pass", "photon_rounds", "newton", "deposit")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="bench512")
    ap.add_argument("--passes", type=int, default=3, help="timed passes")
    ap.add_argument("--out", default=os.path.join(REPO, "chiprun_out",
                                                  "trace_pass.json"))
    args = ap.parse_args()
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " "
                               + NO_COMMAND_BUFFERS).strip()

    import jax
    import numpy as np

    from chip_smoke import card_line
    from raytrace3_tpu.backends import CAM_POS, select_backends
    from raytrace3_tpu.render.driver import build_scene, make_pass_fn
    from raytrace3_tpu.utils.cache import enable_compile_cache
    from raytrace3_tpu.utils.config import get_config
    from raytrace3_tpu.utils.trace import latest_xplane, scope_times

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"trace_pass: needs a GPU, found {dev.platform}",
              file=sys.stderr)
        return 2
    enable_compile_cache()
    cfg = get_config(args.preset)
    scene = build_scene(cfg)
    deposit_fn, newton_fn = select_backends(cfg, scene)
    base = np.asarray(CAM_POS)
    fn = make_pass_fn(scene, cfg, base, base + np.array([0.0, 0.042612,
                                                         -1.0]),
                      deposit_fn=deposit_fn, newton_fn=newton_fn)
    key = jax.random.key(0)
    t0 = time.perf_counter()
    compiled = fn.lower(key).compile()
    compile_s = time.perf_counter() - t0
    _, st = jax.block_until_ready(compiled(key))
    times = []
    for i in range(args.passes):
        t0 = time.perf_counter()
        jax.block_until_ready(compiled(jax.random.key(1 + i)))
        times.append(time.perf_counter() - t0)

    tdir = os.path.join(REPO, "chiprun_out", "trace_tmp")
    shutil.rmtree(tdir, ignore_errors=True)
    jax.profiler.start_trace(tdir)
    jax.block_until_ready(compiled(jax.random.key(99)))
    jax.profiler.stop_trace()
    red = scope_times(latest_xplane(tdir), compiled.as_text(), SCOPES)
    shutil.rmtree(tdir, ignore_errors=True)

    mem = dev.memory_stats() or {}
    rec = {
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": card_line(), "preset": args.preset,
        "xla_flags": os.environ["XLA_FLAGS"],
        "compile_seconds": compile_s,
        "pass_seconds": times,
        "photons_per_pass": float(st["photons_emitted"])
        * scene.light_pos.shape[0],
        "deposits_dropped": int(st["deposits_dropped"]),
        "dropped": int(st["dropped"]),
        "peak_bytes_in_use": mem.get("peak_bytes_in_use"),
        "trace": red,
    }
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
