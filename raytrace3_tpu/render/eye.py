"""PASS 1 — eye trace: bounded wavefront loop emitting SPPM hit points.

Reference: ``RayTracer::{GetHitPoint, ViewTrace}`` (raytracer/Raytracer.h:
102-116, 296-357).  The reference recurses per pixel up to depth 13 and
FOLLOWS EVERY ACTIVE LOBE deterministically: a diffuse lobe stores a HitPoint
(Raytracer.h:312-319) and reflective/refractive lobes recurse (320-336), so a
single pixel may own many hit points, pushed into an unbounded vector.

Wavefront redesign (SURVEY.md C16, hard part (a)):
  * ray state is a fixed ``(R, K)`` slot array (K = ``slots``); a bounce that
    needs BOTH a reflected and a refracted continuation allocates a free slot
    (stable-partition compaction); overflow is counted, not crashed;
  * hit points scatter into a fixed-capacity SoA buffer via prefix-sum slot
    assignment — the vector push_back becomes a masked scatter;
  * depth runs as a ``lax.scan`` of ``max_depth + 1`` segments, matching the
    reference's "check dep > MAX_DEP after the collision" accounting
    (Raytracer.h:306-310).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..core.types import HitPoints, eta_from_refrn, make_hitpoints
from ..core.vecmath import normalize, reflect, refract
from ..geometry.scene import Scene, intersect_scene
from ..ops.compact import compact_indices
from ..ops.onehot import take_rows

#: Reference max trace depth (Raytracer.h:12 ``MAX_DEP 13``).
MAX_DEPTH = 13
#: Reference initial gather radius^2 (Raytracer.h:13 ``INIT_R2 2.0``).
INIT_R2 = 2.0


def _eye_material_lanes(scene: Scene):
    """Combined (N, 13) eye-pass material table [is_diff, is_refl, is_refr,
    diff rgb, refl rgb, refr rgb, refrn], fetched per lane with ONE one-hot
    contraction (see ops/onehot.py — per-index gathers dominate otherwise)."""
    m = scene.materials
    tbl = jnp.concatenate([
        m.is_diff().astype(jnp.float32)[:, None],
        m.is_refl().astype(jnp.float32)[:, None],
        m.is_refr().astype(jnp.float32)[:, None],
        m.diff, m.refl, m.refr, m.refrn[:, None],
    ], axis=1)

    def fetch(obj):
        t = take_rows(tbl, obj)                           # (R, 13)
        return (t[:, 0] > 0.5, t[:, 1] > 0.5, t[:, 2] > 0.5,
                t[:, 3:6], t[:, 6:9], t[:, 9:12], t[:, 12])

    return fetch


def eye_stage_widths(n_rays: int, schedule: tuple,
                     max_depth: int = MAX_DEPTH) -> list[tuple[int, int]]:
    """Static (segments, lane_width) per stage of a compact_schedule.

    Mirrors ``_eye_pass_compact``'s width computation exactly; used for
    ray-throughput accounting (a stage traces segments * width lanes).
    With an empty schedule: one stage of (max_depth + 1, n_rays).
    """
    segs_total = max_depth + 1
    bounds = [0] + [seg for seg, _ in schedule] + [segs_total]
    # The 128-lane floor can exceed a SMALL ray batch
    # (e.g. a per-shard ray slice under photon-axis sharding): clamp each
    # stage to the incoming width — a stage never widens the wavefront.
    widths = [n_rays]
    for _, f in schedule:
        w = max(128, -(-int(n_rays * f)) // 128 * 128)
        widths.append(min(w, widths[-1]))
    return [(hi - lo, w)
            for lo, hi, w in zip(bounds[:-1], bounds[1:], widths)]


def eye_pass(
    scene: Scene,
    org: jnp.ndarray,
    dir: jnp.ndarray,
    capacity: int,
    max_depth: int = MAX_DEPTH,
    slots: int = 1,
    init_r2: float = INIT_R2,
    newton_fn=None,
    pixel_offset=0,
    compact_schedule: tuple = (),
):
    """Trace camera rays, return the hit-point buffer.

    Args:
      org, dir: (R, 3) primary rays in pixel-id order (pixel i = ray i).
      capacity: hit-point buffer capacity C.
      slots:    K ray slots per pixel (K=1 suffices for scenes whose
                materials have at most one specular lobe — true of every
                reference scene, Scene.h:100-113).
      pixel_offset: global id of ray 0 — lets the sharded renderer trace a
                ray shard while keeping hit points addressed by global pixel.
      compact_schedule: ((segment, frac), ...) — at the start of ``segment``
                (>= 1), gather the surviving rays into a buffer of width
                ``frac * R``.  Eye survival collapses fast (measured on the
                reference scene: 20% after segment 1, ~2.5% after 4), so the
                remaining 13 segments need not trace dead lanes.  Rays beyond
                a stage's width are dropped and counted.  Requires slots=1.
    Returns:
      (HitPoints, stats) with stats = {"count": int32, "dropped": int32}.
    """
    if compact_schedule:
        assert slots == 1, "compact_schedule requires slots=1"
        return _eye_pass_compact(
            scene, org, dir, capacity, max_depth, init_r2, newton_fn,
            pixel_offset, compact_schedule,
        )
    R = org.shape[0]
    K = slots
    dtype = org.dtype

    hp = make_hitpoints(capacity, init_r2, dtype)
    pixel_ids = jnp.arange(R, dtype=jnp.int32) + pixel_offset

    fetch_mat = _eye_material_lanes(scene)

    def pad_slots(x, fill=0.0):
        full = jnp.full((R, K) + x.shape[1:], fill, x.dtype)
        return full.at[:, 0].set(x)

    state = dict(
        org=pad_slots(org),
        dir=pad_slots(dir),
        wgt=pad_slots(jnp.ones((R, 3), dtype)),
        active=jnp.zeros((R, K), bool).at[:, 0].set(True),
    )
    buffers = (hp, jnp.int32(0), jnp.int32(0))  # (hitpoints, count, dropped)

    def step(carry, _):
        state, (hp, count, dropped) = carry
        o = state["org"].reshape(R * K, 3)
        d = state["dir"].reshape(R * K, 3)
        act = state["active"].reshape(R * K)
        wgt = state["wgt"].reshape(R * K, 3)

        rec = intersect_scene(scene, o, d, newton_fn=newton_fn)
        obj = jnp.clip(rec.obj_id, 0, scene.n_objects - 1)
        isd, isl, isr, m_diff, m_refl, m_refr, rn = fetch_mat(obj)
        hit = rec.hit & act

        # --- store a hit point at diffuse lobes (Raytracer.h:312-319) ---
        diff_v = hit & isd
        hp_wgt = rec.color * wgt * m_diff
        slot = count + jnp.cumsum(diff_v.astype(jnp.int32)) - 1
        widx = jnp.where(diff_v & (slot < capacity), slot, capacity)  # drop row
        px = jnp.broadcast_to(pixel_ids[:, None], (R, K)).reshape(R * K)
        hp = hp.replace(
            pos=hp.pos.at[widx].set(rec.pos, mode="drop"),
            n=hp.n.at[widx].set(rec.n, mode="drop"),
            wgt=hp.wgt.at[widx].set(hp_wgt, mode="drop"),
            pixel=hp.pixel.at[widx].set(px, mode="drop"),
            valid=hp.valid.at[widx].set(True, mode="drop"),
        )
        n_new = jnp.sum(diff_v.astype(jnp.int32))
        new_count = jnp.minimum(count + n_new, capacity)
        dropped = dropped + (count + n_new - new_count)

        # --- continuations (Raytracer.h:320-336) ---
        refl_v = hit & isl
        refr_v = hit & isr
        d_refl = normalize(reflect(d, rec.n))
        w_refl = rec.color * wgt * m_refl
        eta = eta_from_refrn(rn, rec.inside)
        n_eff = jnp.where(rec.inside[:, None], -rec.n, rec.n)
        d_refr = normalize(refract(d, n_eff, eta))
        w_refr = rec.color * wgt * m_refr

        # Primary continuation reuses the slot; a refr continuation that
        # coexists with refl becomes a secondary candidate for a free slot.
        prim_v = refl_v | refr_v
        prim_d = jnp.where(refl_v[:, None], d_refl, d_refr)
        prim_w = jnp.where(refl_v[:, None], w_refl, w_refr)
        sec_v = refl_v & refr_v

        def shape2(x):
            return x.reshape(R, K, *x.shape[1:])

        cand_v = jnp.concatenate([shape2(prim_v), shape2(sec_v)], axis=1)
        cand_o = jnp.concatenate([shape2(rec.pos)] * 2, axis=1)
        cand_d = jnp.concatenate([shape2(prim_d), shape2(d_refr)], axis=1)
        cand_w = jnp.concatenate([shape2(prim_w), shape2(w_refr)], axis=1)

        if K == 1:
            # Fast path: keep the primary, count dropped secondaries.
            new_state = dict(
                org=cand_o[:, :1], dir=cand_d[:, :1], wgt=cand_w[:, :1],
                active=cand_v[:, :1],
            )
            dropped = dropped + jnp.sum(cand_v[:, 1].astype(jnp.int32))
        else:
            # Stable-partition valid candidates into the first K slots.
            order = jnp.argsort(~cand_v, axis=1, stable=True)
            takek = lambda a: jnp.take_along_axis(
                a, order.reshape(R, 2 * K, *(1,) * (a.ndim - 2)), axis=1
            )[:, :K]
            new_state = dict(
                org=takek(cand_o), dir=takek(cand_d), wgt=takek(cand_w),
                active=takek(cand_v),
            )
            dropped = dropped + jnp.sum(cand_v.astype(jnp.int32)) - jnp.sum(
                new_state["active"].astype(jnp.int32)
            )

        return (new_state, (hp, new_count, dropped)), None

    (state, (hp, count, dropped)), _ = jax.lax.scan(
        step, (state, buffers), None, length=max_depth + 1
    )
    return hp, {"count": count, "dropped": dropped}


def _eye_pass_compact(scene, org, dir, capacity, max_depth, init_r2,
                      newton_fn, pixel_offset, schedule):
    """Staged-width eye trace (see ``eye_pass``'s compact_schedule).

    Same estimator as the slots=1 path: diffuse lobes store hit points,
    exactly one specular continuation per lane (secondaries dropped +
    counted — zero in every reference scene, whose materials have at most
    one specular lobe each, Scene.h:100-113).

    Hit-point candidates stream out of the scans as stacked per-segment
    rows and scatter into the buffer ONCE, packed, at the end — scattering
    the 5 SoA fields into the full-capacity buffer every segment profiled
    at ~94 ms/pass at 512^2 (scatter cost is per index, and this does
    1 x packed instead of 14 x 5).
    """
    R = org.shape[0]
    dtype = org.dtype

    fetch_mat = _eye_material_lanes(scene)

    def step(carry, _):
        (o, d, wgt, px, act), dropped = carry
        rec = intersect_scene(scene, o, d, newton_fn=newton_fn)
        obj = jnp.clip(rec.obj_id, 0, scene.n_objects - 1)
        isd, isl, isr, m_diff, m_refl, m_refr, rn = fetch_mat(obj)
        hit = rec.hit & act

        diff_v = hit & isd
        hp_wgt = rec.color * wgt * m_diff
        # Candidate row: pos3 | n3 | wgt3 | pixel | valid (pixel as f32 is
        # exact below 2^24 — far beyond any canvas).
        rows = jnp.concatenate([
            rec.pos, rec.n, hp_wgt,
            px.astype(dtype)[:, None],
            diff_v.astype(dtype)[:, None],
        ], axis=1)                                         # (w, 11)

        refl_v = hit & isl
        refr_v = hit & isr
        d_refl = normalize(reflect(d, rec.n))
        w_refl = rec.color * wgt * m_refl
        eta = eta_from_refrn(rn, rec.inside)
        n_eff = jnp.where(rec.inside[:, None], -rec.n, rec.n)
        d_refr = normalize(refract(d, n_eff, eta))
        w_refr = rec.color * wgt * m_refr

        prim_v = refl_v | refr_v
        prim_d = jnp.where(refl_v[:, None], d_refl, d_refr)
        prim_w = jnp.where(refl_v[:, None], w_refl, w_refr)
        dropped = dropped + jnp.sum((refl_v & refr_v).astype(jnp.int32))

        return ((rec.pos, prim_d, prim_w, px, prim_v), dropped), rows

    lanes = (org, dir, jnp.ones((R, 3), dtype),
             jnp.arange(R, dtype=jnp.int32) + pixel_offset,
             jnp.ones((R,), bool))
    dropped = jnp.int32(0)

    segs_total = max_depth + 1
    prev = 0
    for seg, _ in schedule:
        assert 0 < seg < segs_total and seg > prev, schedule
        prev = seg

    all_rows = []
    for n_segs, w in eye_stage_widths(R, schedule, max_depth):
        cur_w = lanes[0].shape[0]
        if w < cur_w:
            o, d, wgt, px, act = lanes
            n_act = jnp.sum(act.astype(jnp.int32))
            idx = compact_indices(act, w, fill=cur_w)
            ok = idx < cur_w
            safe = jnp.minimum(idx, cur_w - 1)
            # one packed row gather instead of five (cost is per index)
            lane_rows = jnp.concatenate([
                o, d, wgt, px.astype(dtype)[:, None],
                act.astype(dtype)[:, None],
            ], axis=1)[safe]                                # (w, 11)
            lanes = (lane_rows[:, 0:3], lane_rows[:, 3:6],
                     lane_rows[:, 6:9],
                     lane_rows[:, 9].astype(jnp.int32),
                     (lane_rows[:, 10] > 0.5) & ok)
            dropped = dropped + jnp.maximum(n_act - w, 0)
        (lanes, dropped), rows = jax.lax.scan(
            step, (lanes, dropped), None, length=n_segs,
        )
        all_rows.append(rows.reshape(n_segs * w, 11))

    rows = jnp.concatenate(all_rows, axis=0)               # (K, 11)
    valid = rows[:, 10] > 0.5
    slot = jnp.cumsum(valid.astype(jnp.int32)) - 1
    widx = jnp.where(valid & (slot < capacity), slot, capacity)
    buf = jnp.zeros((capacity, 11), dtype).at[widx].set(rows, mode="drop")

    hp = make_hitpoints(capacity, init_r2, dtype)
    hp = hp.replace(
        pos=buf[:, 0:3], n=buf[:, 3:6], wgt=buf[:, 6:9],
        pixel=buf[:, 9].astype(jnp.int32),
        valid=buf[:, 10] > 0.5,
    )
    n_valid = jnp.sum(valid.astype(jnp.int32))
    count = jnp.minimum(n_valid, capacity)
    dropped = dropped + jnp.maximum(n_valid - capacity, 0)
    return hp, {"count": count, "dropped": dropped}
