"""Sharded SPPM rendering: pass-parallel x photon-sharded over a device mesh.

Reference seam being replaced: ``SPPMRayTracer::render``'s 4-thread OpenMP
pass loop + serial canvas merge (raytracer/Raytracer.h:425-458).

Layout (SURVEY.md section 2, "Parallelism strategies"):
  * mesh axis ``pass``:   each pass-group renders an INDEPENDENT jittered
    SPPM pass (per-group camera jitter from a folded key) — the reference's
    thread loop, now data-parallel across devices/hosts; the canvas merge is a
    mean over the pass axis.
  * mesh axis ``photon``: within a pass-group, eye rays AND photons are
    sharded; local hit-point shards are all-gathered after the eye pass, and
    each round's deposit increments are ``psum``'d before the radius update,
    so hit-point state stays replicated in the group.  All collectives are
    XLA-inserted from ``shard_map`` specs — no hand-written comms.

Determinism: per-device keys are folds of (pass index, shard index), so the
sharded render equals the single-device render with the same total photon
budget re-batched (verified in tests/test_parallel.py).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from ..core.sampling import uniform_sphere
from ..geometry.scene import Scene
from ..render.camera import emit_rays, look_at
from ..render.deposit import deposit_bruteforce
from ..render.eye import eye_pass
from ..render.sppm import estimate_image, photon_rounds
from ..utils.config import RenderConfig
from .mesh import PASS_AXIS, PHOTON_AXIS, make_mesh


def shard_eye_schedule(schedule: tuple, n_shards: int) -> tuple:
    """The staged eye schedule for one of ``n_shards`` contiguous ray shards.

    A schedule's fractions are tuned on the whole image, but contiguous row
    shards split its surviving rays unevenly: the rows through the mirror
    and glass objects keep their rays for many more segments.  Each shard
    therefore keeps the whole image's stage width, ``frac * n_shards`` of its
    own rays (at most all of them), and drops no ray that the one-device
    pass keeps.
    """
    return tuple((seg, min(1.0, frac * n_shards)) for seg, frac in schedule)


def make_sharded_pass_fn(scene: Scene, cfg: RenderConfig, base_pos, base_look,
                         mesh: Mesh, deposit_fn=None, newton_fn=None,
                         hp_sharded: bool = False):
    """Build ``key -> (image, stats)`` where each pass-group renders one
    jittered pass and the result is the mean image over the pass axis.

    The FULL tuned single-chip configuration threads through:
    ``eye_compact_schedule`` (staged wavefront, widened per ray shard by
    :func:`shard_eye_schedule`),
    ``photon_regen`` (persistent lanes), ``deposit_compact_frac``,
    ``debias_roulette``, ``bezier_compact_frac_photon`` (photon-pass
    scene tuning), and deposit backends with ``prepare``/``packed_call``
    run their layout-space rounds inside ``shard_map`` exactly as on one
    chip (the per-round psum happens in layout space — layouts are
    identical across the group because hit points are replicated).

    ``stats`` carries the drop counters summed over the whole mesh
    (``dropped`` = eye-compaction clips, ``deposits_dropped`` = deposit
    compaction clips): silently lost flux must be loud on the sharded path
    too.

    ``hp_sharded``: keep each device's hit-point shard LOCAL (no
    all-gather) and rotate the per-round deposit batches around the photon
    axis instead (``parallel/ring.py``) — SURVEY.md parallel axis #3, for
    canvases whose hit-point state would not fit replicated.  Memory per
    device drops from O(C) to O(C / n_photon) at the cost of n-1 ppermute
    hops per round (overlapped with the local deposit compute).

    Returns a jitted function taking a scalar base key.
    """
    base_pos = jnp.asarray(base_pos, jnp.float32)
    base_look = jnp.asarray(base_look, jnp.float32)
    if deposit_fn is None:
        deposit_fn = deposit_bruteforce
    n_photon = mesh.shape[PHOTON_AXIS]
    n_pass = mesh.shape[PASS_AXIS]
    R = cfg.n_pixels
    if R % n_photon:
        raise ValueError(f"pixels {R} not divisible by photon axis {n_photon}")
    ray_shard = R // n_photon
    local_capacity = cfg.hitpoint_capacity // n_photon
    if cfg.photons_per_round % n_photon:
        raise ValueError("photons_per_round not divisible by photon axis")
    local_photons = cfg.photons_per_round // n_photon
    eye_schedule = shard_eye_schedule(cfg.eye_compact_schedule, n_photon)
    photon_scene = None
    if cfg.bezier_compact_frac_photon >= 0.0 and scene.has_bezier:
        photon_scene = scene.replace(
            bezier_compact_frac=cfg.bezier_compact_frac_photon
        )

    def pass_body(key):
        # Identical within a pass-group; differs across the pass axis.
        pi = jax.lax.axis_index(PASS_AXIS)
        fi = jax.lax.axis_index(PHOTON_AXIS)
        kpass = jax.random.fold_in(key, pi)
        kj, kp = jax.random.split(kpass)

        # Camera jitter (Raytracer.h:429-441), same for the whole group.
        pos = base_pos + cfg.jitter * uniform_sphere(kj)
        cam = look_at(pos, base_look, cfg.width, cfg.height)
        org, dir = emit_rays(cam)

        # --- eye pass on this device's ray shard ---
        org_s = jax.lax.dynamic_slice_in_dim(org, fi * ray_shard, ray_shard)
        dir_s = jax.lax.dynamic_slice_in_dim(dir, fi * ray_shard, ray_shard)
        hp_local, eye_stats = eye_pass(
            scene, org_s, dir_s, local_capacity, cfg.max_depth, cfg.slots,
            cfg.init_r2, newton_fn=newton_fn, pixel_offset=fi * ray_shard,
            compact_schedule=eye_schedule,
        )
        if hp_sharded:
            # --- hit points stay LOCAL; deposits ride the ring ---
            from .ring import photon_rounds_ring

            # photon_rounds_ring folds kp by the shard index itself, so each
            # device traces the same photons as in the replicated branch.
            hp, emitted, dep_drops = photon_rounds_ring(
                photon_scene if photon_scene is not None else scene,
                kp, hp_local, cfg.rounds, local_photons,
                PHOTON_AXIS, cfg.max_depth, cfg.update_mode, deposit_fn,
                newton_fn,
                deposit_compact_frac=cfg.deposit_compact_frac,
                debias_roulette=cfg.debias_roulette,
                regen=cfg.photon_regen,
            )
            # Partial image from the local shard (pixel ids are global);
            # summed over the photon axis below via the same pass psum.
            total = jax.lax.psum(emitted, PHOTON_AXIS)
            img = estimate_image(hp, R, total)
            img = jax.lax.psum(img, PHOTON_AXIS)
        else:
            # Replicate hit points across the group (all-gather).
            hp = jax.tree.map(
                lambda x: jax.lax.all_gather(x, PHOTON_AXIS, axis=0,
                                             tiled=True),
                hp_local,
            )

            # --- photon rounds: local shard of photons, psum'd deposits ---
            kshard = jax.random.fold_in(kp, fi)
            hp, emitted, dep_drops = photon_rounds(
                photon_scene if photon_scene is not None else scene,
                kshard, hp, cfg.rounds, local_photons, cfg.max_depth,
                cfg.update_mode, deposit_fn, newton_fn,
                psum_axis=PHOTON_AXIS,
                deposit_compact_frac=cfg.deposit_compact_frac,
                debias_roulette=cfg.debias_roulette,
                regen=cfg.photon_regen,
            )
            # Normalise by the photons actually emitted ACROSS the group
            # (dynamic under regen; == rounds * photons_per_round without).
            total = jax.lax.psum(emitted, PHOTON_AXIS)
            img = estimate_image(hp, R, total)
        # Mean over independent passes (the reference's canvas merge,
        # Raytracer.h:449-458, as a psum).
        img = jax.lax.psum(img, PASS_AXIS) / n_pass
        stats = {
            "dropped": jax.lax.psum(
                jax.lax.psum(eye_stats["dropped"], PHOTON_AXIS), PASS_AXIS),
            "deposits_dropped": jax.lax.psum(
                jax.lax.psum(dep_drops, PHOTON_AXIS), PASS_AXIS),
            "photons_emitted": jax.lax.psum(total, PASS_AXIS),
        }
        return img, stats

    @jax.jit
    def run(key):
        f = jax.shard_map(
            pass_body, mesh=mesh, in_specs=P(), out_specs=(P(), P()),
            check_vma=False,
        )
        img, stats = f(key)
        return img.reshape(cfg.height, cfg.width, 3), stats

    return run


def render_sharded(cfg: RenderConfig, mesh: Mesh | None = None,
                   scene: Scene | None = None, deposit_fn=None,
                   newton_fn=None, camera_pose=None,
                   hp_sharded: bool = False):
    """Full sharded progressive render (host loop over super-passes).

    Each jit call renders ``n_pass`` jittered passes at once; the host loop
    accumulates ceil(passes / n_pass) such super-passes.
    """
    from ..render.driver import build_scene
    from ..utils.metrics import PassMeter

    if scene is None:
        scene = build_scene(cfg)
    if mesh is None:
        mesh = make_mesh()
    if camera_pose is None:
        base_pos = np.array([50.0, 35.0, 230.0])
        base_look = base_pos + np.array([0.0, 0.042612, -1.0])
    else:
        base_pos, base_look = camera_pose

    n_pass = mesh.shape[PASS_AXIS]
    fn = make_sharded_pass_fn(scene, cfg, base_pos, base_look, mesh,
                              deposit_fn, newton_fn, hp_sharded=hp_sharded)
    n_super = max(1, (cfg.passes + n_pass - 1) // n_pass)
    photons_per_super = (
        n_pass * cfg.rounds * cfg.photons_per_round * scene.light_pos.shape[0]
    )
    rays_per_super = n_pass * (cfg.max_depth + 1) * (
        cfg.n_pixels * cfg.slots
        + cfg.rounds * cfg.photons_per_round * scene.light_pos.shape[0]
    )
    meter = PassMeter(photons_per_super, rays_per_super)

    base_key = jax.random.key(cfg.seed)
    accum = jnp.zeros((cfg.height, cfg.width, 3), jnp.float32)
    stats = {}
    for i in range(n_super):
        meter.start_pass()
        img, stats = fn(jax.random.fold_in(base_key, i))
        accum = accum + img
        jax.block_until_ready(accum)
        meter.end_pass()
    return np.asarray(accum) / n_super, {
        "meter": meter.summary(),
        **{k: int(v) for k, v in stats.items() if k.endswith("dropped")},
    }
