#!/usr/bin/env python
"""Benchmark: photons/s of the ``bench512`` preset (full teapot caustics
scene at 512x512) on one GPU.

Prints ONE JSON line:
  {"metric": "photons_per_s_teapot512", "value": N, "unit": "photons/s",
   "vs_baseline": N | "not measured", "device": {...}, ...}

``vs_baseline`` is measured against the C++ implementation of the
reference algorithm (native/baseline_sppm.cpp — same workload: Newton
10x(50-restart) ray-Bezier intersection, depth-13 walks, r^2=2 deposits),
built and timed on this host's CPU with all cores, like the reference's
OpenMP setup (BASELINE.md: the reference publishes no numbers, so the
baseline is measured here).  If the C++ build or run fails, the error is
reported and ``vs_baseline`` is "not measured".

Refuses to run without a GPU: a CPU timing is not this benchmark.

Env knobs: RT3_BENCH_ROUNDS, RT3_BENCH_PHOTONS, RT3_BENCH_RES,
RT3_BENCH_TIMED (timed passes, default 4).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)


def measure_cpp_baseline(reps: int = 3) -> dict:
    """Build + run the C++ baseline; returns its JSON record.

    A single run on a shared host is noisy, so take the median photons/s
    of ``reps`` runs.
    """
    src = os.path.join(REPO, "native", "baseline_sppm.cpp")
    exe = os.path.join(REPO, "native", "baseline_sppm")
    if not os.path.exists(exe) or os.path.getmtime(exe) < os.path.getmtime(src):
        subprocess.run(
            ["g++", "-O3", "-march=native", "-fopenmp", "-std=c++17", src,
             "-o", exe],
            check=True,
        )
    threads = os.cpu_count() or 1
    runs = []
    for _ in range(max(reps, 1)):
        out = subprocess.run(
            [exe, os.path.join(REPO, "assets", "teapot.bpt"), "512", "2000",
             str(threads)],
            check=True, capture_output=True, text=True, timeout=1800,
        ).stdout.strip()
        runs.append(json.loads(out.splitlines()[-1]))
    runs.sort(key=lambda r: float(r["photons_per_s"]))
    med = runs[len(runs) // 2]
    med["photons_per_s_runs"] = [float(r["photons_per_s"]) for r in runs]
    return med


def main() -> int:
    import jax

    dev = jax.devices()[0]
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    if dev.platform != "gpu":
        print(f"bench: needs a GPU, found {device}", file=sys.stderr)
        return 2

    try:
        cpp = measure_cpp_baseline()
        baseline_pps = float(cpp["photons_per_s"])
    except (OSError, subprocess.SubprocessError, ValueError, KeyError) as e:
        print(f"bench: C++ baseline not measured: {e!r}", file=sys.stderr)
        cpp = {"error": repr(e)}
        baseline_pps = None

    import jax.numpy as jnp
    import numpy as np

    from raytrace3_tpu.backends import CAM_POS, select_backends
    from raytrace3_tpu.render.driver import build_scene, make_pass_fn
    from raytrace3_tpu.render.eye import eye_stage_widths
    from raytrace3_tpu.utils.cache import enable_compile_cache
    from raytrace3_tpu.utils.config import get_config

    enable_compile_cache()
    res = int(os.environ.get("RT3_BENCH_RES", "512"))
    cfg = get_config("bench512").replace(
        width=res, height=res, passes=1,
        rounds=int(os.environ.get("RT3_BENCH_ROUNDS", "16")),
        photons_per_round=int(os.environ.get("RT3_BENCH_PHOTONS", "131072")))
    n_timed = int(os.environ.get("RT3_BENCH_TIMED", "4"))
    scene = build_scene(cfg)
    deposit_fn, newton_fn = select_backends(cfg, scene)
    base = np.asarray(CAM_POS)
    look = base + np.array([0.0, 0.042612, -1.0])
    fn = make_pass_fn(scene, cfg, base, look, deposit_fn=deposit_fn,
                      newton_fn=newton_fn)

    print(f"bench: {device} warming up / compiling ...", file=sys.stderr,
          flush=True)
    key = jax.random.key(0)
    t0 = time.perf_counter()
    img, stats = fn(key)
    jax.block_until_ready(img)
    compile_s = time.perf_counter() - t0
    print(f"bench: compile+first pass {compile_s:.1f}s; timing ...",
          file=sys.stderr, flush=True)

    # Warm every auxiliary graph (fold_in, the stack/sum reduction) before
    # the clock starts, then dispatch all timed passes without touching
    # their outputs and read one scalar at the end.
    keys = [jax.random.fold_in(key, i + 1) for i in range(n_timed)]
    jax.device_get(jnp.stack([stats["photons_emitted"]] * n_timed).sum())
    jax.block_until_ready(keys)

    t0 = time.perf_counter()
    emitted_acc = []
    for k in keys:
        img, stats = fn(k)
        emitted_acc.append(stats["photons_emitted"])
    emitted = float(jax.device_get(jnp.stack(emitted_acc).sum()))
    dt = (time.perf_counter() - t0) / n_timed
    # photons_emitted is per light; the full scene has one light
    photons = emitted / n_timed * scene.light_pos.shape[0]

    pps = photons / dt
    # Traced ray segments per pass: eye = staged wavefront widths x segment
    # counts; photon = regen keeps every lane live for all rounds x
    # (max_depth + 1) segments.
    eye_rays = sum(s * w for s, w in eye_stage_widths(
        res * res, cfg.eye_compact_schedule, cfg.max_depth))
    photon_rays = cfg.rounds * (cfg.max_depth + 1) * cfg.photons_per_round
    record = {
        "metric": "photons_per_s_teapot512",
        "value": pps,
        "unit": "photons/s",
        "vs_baseline": (pps / baseline_pps if baseline_pps
                        else "not measured"),
        "device": device,
        "preset": "bench512",
        "deposit": getattr(deposit_fn, "__name__",
                           type(deposit_fn).__name__),
        "newton_restarts": cfg.newton_restarts,
        "mrays_per_s": (eye_rays + photon_rays) / dt / 1e6,
        "pass_seconds": dt,
        "compile_seconds": compile_s,
        "photons_per_pass": photons,
        "deposits_dropped": int(stats["deposits_dropped"]),
        "eye_dropped": int(stats["dropped"]),
        "hitpoints": int(stats["count"]),
        "cpp_baseline": cpp,
    }
    print(json.dumps(record))
    # Silently lost flux invalidates the metric: both drop counters must be
    # zero (deposit overflow + eye-compaction clipping).
    if record["deposits_dropped"] or record["eye_dropped"]:
        print("bench: dropped flux", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
