#!/usr/bin/env python
"""Smoke test of the SPPM renderer on one NVIDIA GPU, at full width.

    python chip_smoke.py            # one GPU: the phases below
    python chip_smoke.py --mesh4    # four GPUs: the sharded phases only

Phases (one process, one card; any failure exits non-zero and prints no
result line):
  1. the device is a GPU; print its kind and count and nvidia-smi's name
     and power limit;
  2. compile the banded Triton deposit at bench512 widths and print the
     compiled memory analysis;
  3. on one real round (the 512^2 eye pass plus one 131072-lane regen photon
     round) compare it with the bruteforce oracle at Precision.HIGHEST:
     counts exactly, flux to rtol 1e-4 (fp32 sums in another order);
     print both deposits' time for the round;
  4. solve the AABB-compacted 512^2 eye rays with the jnp Newton at 8 and at
     64 starts: no ray the 64-start solve hits is missed, and at most 2% of
     the hits pick a different root (t differs by more than 1e-3 relative);
  5. render bench512 for 3 passes through ``raytrace3_tpu.cli.main``: the
     image is finite and non-zero, nothing is dropped; print photons/s and
     compile seconds.

``--mesh4`` runs, on a 4-GPU host and with the ``sharded10m`` preset at its
own 8 rounds per pass: the (4,1) pass mesh against the mean of 4
single-device passes with the same keys; the (1,4) photon mesh (no drops,
mean radiance within 2% of the single-device pass); the hit-point-sharded
ring against the replicated photon mesh; and checks that devices 1-3 did
real work.  Then one ``bench512`` pass through ``render_sharded`` (what
``rt3 --preset bench512 --sharded`` runs) on the (1,4) photon mesh, whose
staged eye schedule must drop nothing.  All with the banded Triton deposit
inside ``shard_map``.

The last stdout line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
PRESET = "bench512"
MESH4_PRESET = "sharded10m"


class PhaseFailed(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseFailed(msg)


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    """nvidia-smi's 'name, power.limit' for every card, or why not."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        return out.stdout.strip() or f"nvidia-smi: {out.stderr.strip()}"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e!r}"


def import_package():
    """Import the renderer from THIS checkout (never an installed copy)."""
    sys.path.insert(0, REPO)
    import raytrace3_tpu

    here = os.path.dirname(os.path.abspath(raytrace3_tpu.__file__))
    check(os.path.dirname(here) == REPO,
          f"raytrace3_tpu imported from {here}, not from {REPO}")
    return raytrace3_tpu


def camera(cfg):
    import jax.numpy as jnp
    import numpy as np

    from raytrace3_tpu.backends import CAM_POS
    from raytrace3_tpu.render.camera import emit_rays, look_at

    base = np.asarray(CAM_POS)
    look = base + np.array([0.0, 0.042612, -1.0])
    cam = look_at(jnp.asarray(base, jnp.float32),
                  jnp.asarray(look, jnp.float32), cfg.width, cfg.height)
    return base, look, emit_rays(cam)


def one_round(cfg, scene, newton_fn, key):
    """(hp, dep): the eye pass plus one regen photon round."""
    from raytrace3_tpu.render.eye import eye_pass
    from raytrace3_tpu.render.photon import photon_trace_regen

    _, _, (org, dirs) = camera(cfg)
    hp, _ = eye_pass(scene, org, dirs, cfg.hitpoint_capacity, cfg.max_depth,
                     cfg.slots, cfg.init_r2, newton_fn=newton_fn,
                     compact_schedule=cfg.eye_compact_schedule)
    photon_scene = scene.replace(
        bezier_compact_frac=cfg.bezier_compact_frac_photon)
    dep, _, _ = photon_trace_regen(
        photon_scene, key, scene.light_pos, scene.light_color,
        cfg.photons_per_round, None, cfg.max_depth, newton_fn=newton_fn)
    return hp, dep


def median_seconds(fn, *args, reps: int = 3):
    """(median seconds of ``reps`` calls after a warm one, the output)."""
    import jax

    out = jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return sorted(ts)[len(ts) // 2], out


def phase_deposit(cfg, scene, deposit_fn, newton_fn):
    import jax
    import numpy as np

    from raytrace3_tpu.render.deposit import deposit_bruteforce

    gen = jax.jit(lambda k: one_round(cfg, scene, newton_fn, k))
    hp_s, dep_s = jax.eval_shape(gen, jax.random.key(1))
    t0 = time.perf_counter()
    compiled = jax.jit(deposit_fn).lower(hp_s, dep_s).compile()
    log(f"phase 2 compile: banded deposit C={hp_s.capacity} "
        f"D={dep_s.pos.shape[0]} tile={deposit_fn.tile} "
        f"chunk={deposit_fn.chunk} warps={deposit_fn.num_warps} "
        f"in {time.perf_counter() - t0:.2f}s")
    log(f"phase 2 memory_analysis: {compiled.memory_analysis()}")

    hp, dep = gen(jax.random.key(1))
    banded_s, (cnt, tao) = median_seconds(compiled, hp, dep)
    with jax.default_matmul_precision("highest"):
        ref_s, (ref_cnt, ref_tao) = median_seconds(
            jax.jit(deposit_bruteforce), hp, dep)
    log(f"phase 3 deposit ms/round: banded={banded_s * 1e3:.3f} "
        f"bruteforce={ref_s * 1e3:.3f} (median of 3, one round)")
    cnt, tao, ref_cnt, ref_tao = map(np.asarray, (cnt, tao, ref_cnt, ref_tao))
    n_valid = int(np.asarray(hp.valid).sum())
    n_dep = int(np.asarray(dep.valid).sum())
    bad = int((cnt != ref_cnt).sum())
    rel = np.abs(tao - ref_tao) / np.maximum(np.abs(ref_tao), 1e-30)
    rel = np.where(ref_tao == tao, 0.0, rel)
    log(f"phase 3 deposit vs bruteforce: hitpoints={n_valid} "
        f"deposits={n_dep} pairs={int(ref_cnt.sum())} "
        f"count_mismatches={bad} flux_max_rel_err={float(rel.max()):.3e} "
        f"flux_max_abs_err={float(np.abs(tao - ref_tao).max()):.3e}")
    check(n_valid > 0 and n_dep > 0 and ref_cnt.sum() > 0,
          "empty deposit round")
    check(bad == 0, f"{bad} hit points with different photon counts")
    check(rel.max() <= 1e-4, f"flux rel err {rel.max()} > 1e-4")


def phase_newton(cfg, scene):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from raytrace3_tpu.geometry.aabb import aabb_from_points, slab_test
    from raytrace3_tpu.geometry.bezier import solve_winner

    _, _, (org, dirs) = camera(cfg)
    ctrl = scene.bezier.ctrl
    pmin, pmax = aabb_from_points(ctrl.reshape(-1, 3))
    gate = np.asarray(slab_test(org, dirs, pmin, pmax))
    idx = np.flatnonzero(gate)
    o, d = org[idx], dirs[idx]
    solve = jax.jit(solve_winner, static_argnames=("iters", "restarts"))
    out = {}
    for n in (cfg.newton_restarts, 64):
        t, _, _, _, hit = solve(o, d, ctrl, iters=cfg.newton_iters,
                                restarts=n)
        out[n] = (np.asarray(t), np.asarray(hit))
    (t8, h8), (t64, h64) = out[cfg.newton_restarts], out[64]
    both = h8 & h64
    tdiff = np.abs(t8 - t64) / np.maximum(t64, 1e-6)
    miss = int((h64 & ~h8).sum())
    false_hit = int((h8 & ~h64).sum())
    root_diff = int((both & (tdiff > 1e-3)).sum())
    share = root_diff / max(int(h64.sum()), 1)
    log(f"phase 4 newton {cfg.newton_restarts} vs 64 starts: "
        f"rays={idx.size} hits64={int(h64.sum())} misses={miss} "
        f"false_hits={false_hit} root_diff={root_diff} "
        f"root_diff_share={share:.4f}")
    check(h64.sum() > 0, "no eye ray hits the teapot")
    check(miss == 0, f"{miss} eye rays missed by {cfg.newton_restarts} starts")
    check(share <= 0.02, f"root-difference share {share:.4f} > 2%")


def phase_cli(card):
    import numpy as np

    from raytrace3_tpu.cli import main as cli_main
    from raytrace3_tpu.utils import checkpoint as ckpt

    with tempfile.TemporaryDirectory(dir=REPO) as tmp:
        jsonl = os.path.join(tmp, "metrics.jsonl")
        ck = os.path.join(tmp, "accum.npz")
        rc = cli_main(["--preset", PRESET, "--passes", "3",
                       "--preview-every", "0", "--metrics-jsonl", jsonl,
                       "--checkpoint", ck,
                       "--out", os.path.join(tmp, "render.png")])
        check(rc == 0, f"cli returned {rc}")
        accum, passes, _, _ = ckpt.load(ck)
        with open(jsonl) as f:
            recs = [json.loads(line) for line in f]
    img = accum / passes
    check(passes == 3 and len(recs) == 3, f"{passes} passes, {len(recs)} "
          "metric records")
    check(np.isfinite(img).all(), "non-finite image")
    check(img.max() > 0, "black image")
    dropped = sum(r["dropped"] for r in recs)
    dep_dropped = sum(r["deposits_dropped"] for r in recs)
    steady = recs[1:]
    pass_s = sum(r["pass_seconds"] for r in steady) / len(steady)
    pps = sum(r["photons_per_s"] for r in steady) / len(steady)
    compile_s = recs[0]["pass_seconds"] - pass_s
    log(f"phase 5 cli {PRESET}: passes=3 mean_radiance={img.mean():.6g} "
        f"hitpoints={recs[-1]['hitpoints']} dropped={dropped} "
        f"deposits_dropped={dep_dropped}")
    log(f"phase 5 throughput: photons_per_s={pps:.6g} "
        f"pass_seconds={pass_s:.4f} compile_seconds={compile_s:.2f} "
        f"first_pass_seconds={recs[0]['pass_seconds']:.2f} card: {card}")
    check(dropped == 0, f"eye pass dropped {dropped} rays")
    check(dep_dropped == 0, f"{dep_dropped} deposits dropped")


def mesh4_phases(cfg, scene, deposit_fn, newton_fn, devices):
    """The four-device phases (also rehearsable on 4 virtual CPU devices)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from raytrace3_tpu.core.sampling import uniform_sphere
    from raytrace3_tpu.parallel.mesh import make_mesh
    from raytrace3_tpu.parallel.shard import make_sharded_pass_fn
    from raytrace3_tpu.render.camera import emit_rays, look_at
    from raytrace3_tpu.render.sppm import render_pass

    check(len(devices) == 4, f"need 4 devices, have {len(devices)}")
    base, look, _ = camera(cfg)
    key = jax.random.key(3)
    photon_scene = None                 # as make_sharded_pass_fn builds it
    if cfg.bezier_compact_frac_photon >= 0.0 and scene.has_bezier:
        photon_scene = scene.replace(
            bezier_compact_frac=cfg.bezier_compact_frac_photon)

    @jax.jit
    def single(kpass):
        """One pass group's pass on one device, keyed like pass_body."""
        kj, kp = jax.random.split(kpass)
        pos = jnp.asarray(base, jnp.float32) + cfg.jitter * uniform_sphere(kj)
        cam = look_at(pos, jnp.asarray(look, jnp.float32), cfg.width,
                      cfg.height)
        org, dirs = emit_rays(cam)
        img, stats = render_pass(
            scene, org, dirs, jax.random.fold_in(kp, 0),
            hitpoint_capacity=cfg.hitpoint_capacity, n_rounds=cfg.rounds,
            photons_per_round=cfg.photons_per_round,
            max_depth=cfg.max_depth, slots=cfg.slots, init_r2=cfg.init_r2,
            update_mode=cfg.update_mode, deposit_fn=deposit_fn,
            newton_fn=newton_fn,
            deposit_compact_frac=cfg.deposit_compact_frac,
            photon_scene=photon_scene, photon_regen=cfg.photon_regen,
            eye_compact_schedule=cfg.eye_compact_schedule)
        return img.reshape(cfg.height, cfg.width, 3), stats

    def sharded(n_pass, n_photon, hp_sharded=False):
        mesh = make_mesh(n_pass, n_photon, devices=devices)
        fn = make_sharded_pass_fn(scene, cfg, base, look, mesh,
                                  deposit_fn=deposit_fn, newton_fn=newton_fn,
                                  hp_sharded=hp_sharded)
        t0 = time.perf_counter()
        img, stats = jax.block_until_ready(fn(key))
        stats = {k: int(v) for k, v in stats.items() if k.endswith("dropped")}
        return np.asarray(img), stats, time.perf_counter() - t0

    singles = []
    for pi in range(4):
        img, stats = single(jax.random.fold_in(key, pi))
        check(int(stats["dropped"]) == 0
              and int(stats["deposits_dropped"]) == 0,
              f"single-device pass {pi} dropped {stats}")
        singles.append(np.asarray(img))
    want = sum(singles) / 4.0

    img, stats, dt = sharded(4, 1)
    err = float(np.abs(img - want).max())
    scale = float(np.abs(want).max())
    log(f"mesh4 pass axis (4,1): {stats} max_abs_err={err:.3e} "
        f"max_radiance={scale:.4g} first_call_s={dt:.1f}")
    check(not any(stats.values()), f"pass mesh dropped {stats}")
    check(np.allclose(img, want, rtol=1e-5, atol=1e-6),
          "pass-axis mesh differs from the mean of 4 single-device passes")

    rep, stats, dt = sharded(1, 4)
    rel = abs(rep.mean() - singles[0].mean()) / singles[0].mean()
    log(f"mesh4 photon axis (1,4): {stats} mean_radiance={rep.mean():.6g} "
        f"single_device={singles[0].mean():.6g} rel_diff={rel:.4f} "
        f"first_call_s={dt:.1f}")
    check(not any(stats.values()), f"photon mesh dropped {stats}")
    check(rel <= 0.02, f"photon-axis mean radiance off by {rel:.4f} > 2%")
    peaks = [d.memory_stats()["peak_bytes_in_use"]
             if d.memory_stats() else None for d in devices]
    log(f"mesh4 per-device peak bytes: {peaks}")
    if all(p is not None for p in peaks):
        check(min(peaks[1:]) >= 0.25 * peaks[0],
              f"devices 1-3 hold little of the work: {peaks}")

    ring, stats, dt = sharded(1, 4, hp_sharded=True)
    # Same photons and hit points as the replicated pass; the per-hit-point
    # sums over the four deposit batches are added in ring order instead of
    # psum order, and radius updates carry the last-bit differences on.
    err = float(np.abs(ring - rep).max()) / float(np.abs(rep).max())
    mean_rel = abs(ring.mean() - rep.mean()) / rep.mean()
    log(f"mesh4 ring (hp-sharded) vs replicated: {stats} "
        f"max_err/max={err:.3e} mean_rel_diff={mean_rel:.3e} "
        f"first_call_s={dt:.1f}")
    check(not any(stats.values()), f"ring dropped {stats}")
    check(err <= 1e-3 and mean_rel <= 1e-4,
          "ring pass differs from the replicated photon-axis pass")


def mesh4_tuned_preset(devices):
    """One ``bench512`` pass on the (1,4) photon mesh through
    ``render_sharded``: no eye ray or deposit is dropped."""
    import numpy as np

    from raytrace3_tpu.backends import select_backends
    from raytrace3_tpu.parallel.mesh import make_mesh
    from raytrace3_tpu.parallel.shard import render_sharded
    from raytrace3_tpu.render.driver import build_scene
    from raytrace3_tpu.utils.config import get_config

    cfg = get_config(PRESET).replace(passes=1)
    scene = build_scene(cfg)
    deposit_fn, newton_fn = select_backends(cfg, scene)
    t0 = time.perf_counter()
    img, metrics = render_sharded(cfg, mesh=make_mesh(1, 4, devices=devices),
                                  scene=scene, deposit_fn=deposit_fn,
                                  newton_fn=newton_fn)
    drops = {k: v for k, v in metrics.items() if k.endswith("dropped")}
    log(f"mesh4 {PRESET} on the (1,4) photon mesh: {drops} "
        f"mean_radiance={img.mean():.6g} first_call_s="
        f"{time.perf_counter() - t0:.1f}")
    check(np.isfinite(img).all() and img.max() > 0, "bad sharded image")
    check(drops and not any(drops.values()), f"{PRESET} sharded dropped "
          f"{drops}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mesh4", action="store_true",
                    help="run only the four-GPU sharded phases")
    args = ap.parse_args(argv)

    try:
        import jax
    except ImportError as e:
        print(f"chip_smoke: JAX is not installed: {e}", file=sys.stderr)
        return 1
    devices = jax.devices()
    dev = devices[0]
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(devices)}
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {device}", file=sys.stderr)
        return 1
    card = card_line()
    log(f"phase 1 device: {device} card: {card}")
    want = 4 if args.mesh4 else 1
    if len(devices) < want:
        print(f"chip_smoke: needs {want} GPUs, found {len(devices)}",
              file=sys.stderr)
        return 1
    try:
        import_package()
    except (ImportError, PhaseFailed) as e:
        print(f"chip_smoke: cannot import the renderer: {e}",
              file=sys.stderr)
        return 1

    from raytrace3_tpu.backends import select_backends
    from raytrace3_tpu.render.driver import build_scene
    from raytrace3_tpu.utils.cache import enable_compile_cache
    from raytrace3_tpu.utils.config import get_config

    enable_compile_cache()
    cfg = get_config(MESH4_PRESET if args.mesh4 else PRESET)
    scene = build_scene(cfg)
    deposit_fn, newton_fn = select_backends(cfg, scene)
    if args.mesh4:
        phases = [
            ("mesh4", lambda: mesh4_phases(cfg, scene, deposit_fn, newton_fn,
                                           devices[:4])),
            ("mesh4_tuned", lambda: mesh4_tuned_preset(devices[:4])),
        ]
    else:
        phases = [
            ("deposit", lambda: phase_deposit(cfg, scene, deposit_fn,
                                              newton_fn)),
            ("newton", lambda: phase_newton(cfg, scene)),
            ("cli", lambda: phase_cli(card)),
        ]
    failed = []
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            fn()
            log(f"{name}: ok in {time.perf_counter() - t0:.1f}s")
        except Exception as e:  # report every phase, then fail as a whole
            failed.append(name)
            log(f"{name}: FAILED {type(e).__name__}: {e}")
    if failed:
        print(f"chip_smoke: failed phases {failed}", file=sys.stderr)
        return 1
    log(f"card: {card}")
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
