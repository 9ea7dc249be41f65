"""Multi-pass SPPM driver: the reference's outer progressive loop, redesigned.

Reference: ``SPPMRayTracer::render`` (raytracer/Raytracer.h:421-477): 100000
passes, each running FOUR OpenMP threads with camera positions jittered by
0.00015 * random unit vector, merging canvases serially, tone-mapping the
running average, and saving a JPEG every pass.

Here one pass = one pure jitted function ``key -> image`` (the
camera jitter, basis rebuild and ray generation all trace into the graph);
the host loop just folds keys, accumulates on device, and handles
checkpoint/preview I/O.  The OpenMP fan-out is replaced by the mesh
pass-parallelism in ``parallel/shard.py`` — on one device this loop plays the
role of the reference's serial merge.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..core.sampling import uniform_sphere
from ..geometry.scene import Scene
from ..scenes import get_scene
from ..utils import checkpoint as ckpt
from ..utils.config import RenderConfig
from ..utils.image import save_png
from ..utils.metrics import PassMeter
from .camera import emit_rays, look_at
from .deposit import deposit_bruteforce
from .sppm import render_pass


def build_scene(cfg: RenderConfig) -> Scene:
    scene = get_scene(cfg.scene, atlas_res=cfg.atlas_res)
    return scene.replace(
        bezier_compact_frac=cfg.bezier_compact_frac,
        newton_iters=cfg.newton_iters,
        newton_restarts=cfg.newton_restarts,
    )


def make_pass_fn(scene: Scene, cfg: RenderConfig, base_pos, base_look,
                 deposit_fn=None, newton_fn=None):
    """Build the jitted single-pass function ``key -> (image, stats)``.

    The camera jitter (Raytracer.h:429-441: pos + 0.00015 * unit random,
    then lookAt) happens INSIDE the jit on a folded key, so every pass is a
    pure function of its key.
    """
    base_pos = jnp.asarray(base_pos, jnp.float32)
    base_look = jnp.asarray(base_look, jnp.float32)
    if deposit_fn is None:
        deposit_fn = deposit_bruteforce
    photon_scene = None
    if cfg.bezier_compact_frac_photon >= 0.0 and scene.has_bezier:
        photon_scene = scene.replace(
            bezier_compact_frac=cfg.bezier_compact_frac_photon
        )

    def one_pass(key):
        kj, kp = jax.random.split(key)
        pos = base_pos + cfg.jitter * uniform_sphere(kj)
        cam = look_at(pos, base_look, cfg.width, cfg.height)
        org, dir = emit_rays(cam)
        img, stats = render_pass(
            scene, org, dir, kp,
            hitpoint_capacity=cfg.hitpoint_capacity,
            n_rounds=cfg.rounds,
            photons_per_round=cfg.photons_per_round,
            max_depth=cfg.max_depth,
            slots=cfg.slots,
            init_r2=cfg.init_r2,
            update_mode=cfg.update_mode,
            deposit_fn=deposit_fn,
            newton_fn=newton_fn,
            deposit_compact_frac=cfg.deposit_compact_frac,
            debias_roulette=cfg.debias_roulette,
            photon_scene=photon_scene,
            photon_regen=cfg.photon_regen,
            eye_compact_schedule=cfg.eye_compact_schedule,
        )
        return img.reshape(cfg.height, cfg.width, 3), stats

    return jax.jit(one_pass)


def render(cfg: RenderConfig, scene: Scene | None = None,
           checkpoint_path: str | None = None, preview_every: int = 0,
           metrics_jsonl: str | None = None, deposit_fn=None, newton_fn=None,
           camera_pose=None, profile_dir: str | None = None):
    """Run the full progressive render; returns (mean image HxWx3, metrics).

    Resumable: with ``checkpoint_path`` set, an interrupted render restarts
    at the last saved pass and reproduces the uninterrupted result exactly
    (pass i always uses fold_in(seed_key, i)).
    """
    if scene is None:
        scene = build_scene(cfg)
    if camera_pose is None:
        base_pos = np.array([50.0, 35.0, 230.0])         # main.cpp:24
        base_look = base_pos + np.array([0.0, 0.042612, -1.0])  # main.cpp:27
    else:
        base_pos, base_look = camera_pose

    pass_fn = make_pass_fn(scene, cfg, base_pos, base_look,
                           deposit_fn, newton_fn)
    base_key = jax.random.key(cfg.seed)

    accum = jnp.zeros((cfg.height, cfg.width, 3), jnp.float32)
    start_pass = 0
    if checkpoint_path:
        state = ckpt.load(checkpoint_path)
        if state is not None:
            saved_accum, start_pass, saved_seed, _ = state
            assert saved_seed == cfg.seed, "checkpoint seed mismatch"
            accum = jnp.asarray(saved_accum)

    photons_per_pass = (
        cfg.rounds * cfg.photons_per_round * scene.light_pos.shape[0]
    )
    # Traced ray segments per pass (upper bound: every lane, every segment).
    rays_per_pass = (cfg.max_depth + 1) * (
        cfg.n_pixels * cfg.slots
        + cfg.rounds * cfg.photons_per_round * scene.light_pos.shape[0]
    )
    meter = PassMeter(photons_per_pass, rays_per_pass, metrics_jsonl)

    stats = {}
    for i in range(start_pass, cfg.passes):
        meter.start_pass()
        # Profile the second pass (first is compile) when requested —
        # the reference had no profiling at all (SURVEY.md section 5).
        do_profile = profile_dir and i == start_pass + 1
        if do_profile:
            jax.profiler.start_trace(profile_dir)
        img, stats = pass_fn(jax.random.fold_in(base_key, i))
        accum = accum + img
        jax.block_until_ready(accum)
        if do_profile:
            jax.profiler.stop_trace()
        meter.end_pass({"hitpoints": int(stats["count"]),
                        "dropped": int(stats["dropped"]),
                        "deposits_dropped": int(stats["deposits_dropped"]),
                        "mean_r2": float(stats["mean_r2"])},
                       photons=float(stats["photons_emitted"])
                       * scene.light_pos.shape[0])
        if checkpoint_path and cfg.checkpoint_every and (
            (i + 1) % cfg.checkpoint_every == 0
        ):
            ckpt.save(checkpoint_path, np.asarray(accum), i + 1, cfg.seed)
        if preview_every and (i + 1) % preview_every == 0:
            save_png(cfg.out, np.asarray(accum) / (i + 1))

    mean_img = np.asarray(accum) / max(cfg.passes, 1)
    if checkpoint_path:
        ckpt.save(checkpoint_path, np.asarray(accum), cfg.passes, cfg.seed)
    return mean_img, {"meter": meter.summary(), **{
        k: (int(v) if hasattr(v, "dtype") and v.dtype == jnp.int32 else float(v))
        for k, v in stats.items()
    }}
