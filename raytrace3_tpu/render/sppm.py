"""SPPM engine: photon rounds, progressive radius update, image estimate.

Reference: ``RayTracer::{PhotonMap, render}`` + ``HitPoint::update``
(raytracer/Raytracer.h:69-79, 210-295, 366-387) and the tone map ``toInt``
(Raytracer.h:24-26).

Progressive-update modes:
  * ``"sppm"`` (default) — the textbook PPM shrink: when a hit point gains
    dN photons in a round, k = (N + a dN) / (N + dN); r2 *= k;
    tao = (tao + dtao) * k; N += a dN, with a = 0.7 (Raytracer.h:45).
  * ``"reference"`` — bit-faithful to the reference AS EXECUTED: the guard
    ``if (N <= 0 || newN <= 0) return;`` (Raytracer.h:74) makes the whole
    update unreachable (N starts at 0 and is only ever incremented inside the
    guarded branch), so radii never shrink and tao accumulates unscaled.
    SURVEY.md documents the surrounding quirks; this dead-code one is why the
    reference is effectively fixed-radius PPM averaged over jittered passes.

The per-round loop is a ``lax.scan`` carrying the full hit-point state —
pass-level purity (key -> image) is what makes checkpoint/resume and
multi-chip pass parallelism trivial (SURVEY.md section 5).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..core.types import HitPoints
from ..geometry.scene import Scene
from .deposit import deposit_bruteforce
from .eye import INIT_R2, MAX_DEPTH, eye_pass
from .light import emit_photons
from .photon import (compact_deposits, photon_trace, photon_trace_regen,
                     regen_state_init)

#: Reference radius-shrink factor (Raytracer.h:45).
ALPHA = 0.7


def ppm_update_arrays(r2, tao, nphot, d_nphot, d_tao,
                      mode: str = "sppm", alpha: float = ALPHA):
    """The PPM shrink on bare arrays (works in hp order OR the deposit
    backend's layout space — the update is elementwise)."""
    if mode == "reference":
        return r2, tao + d_tao, nphot + d_nphot
    if mode != "sppm":
        raise ValueError(f"unknown ppm update mode: {mode}")
    has_new = d_nphot > 0.0
    denom = jnp.where(has_new, nphot + d_nphot, 1.0)
    k = jnp.where(has_new, (nphot + alpha * d_nphot) / denom, 1.0)
    return r2 * k, (tao + d_tao) * k[:, None], nphot + alpha * d_nphot


def ppm_update(hp: HitPoints, d_nphot: jnp.ndarray, d_tao: jnp.ndarray,
               mode: str = "sppm", alpha: float = ALPHA) -> HitPoints:
    """Fold one round's deposits into the hit-point state."""
    r2, tao, nphot = ppm_update_arrays(
        hp.r2, hp.tao, hp.nphot, d_nphot, d_tao, mode, alpha)
    return hp.replace(r2=r2, tao=tao, nphot=nphot)


def photon_rounds(
    scene: Scene,
    key: jax.Array,
    hp: HitPoints,
    n_rounds: int,
    photons_per_round: int,
    max_depth: int = MAX_DEPTH,
    update_mode: str = "sppm",
    deposit_fn=deposit_bruteforce,
    newton_fn=None,
    psum_axis: str | None = None,
    deposit_compact_frac: float = 1.0,
    debias_roulette: bool = False,
    regen: bool = False,
):
    """Run the photon-mapping rounds (reference PhotonMap, Raytracer.h:210-295).

    ``photons_per_round`` photons are emitted PER LIGHT each round (the
    reference's ``onetime`` = 100, Raytracer.h:218; we default much larger
    rounds — same estimator, radically better device utilisation).

    ``psum_axis``: when running inside ``shard_map`` with photons sharded
    over a mesh axis, pass its name — each device traces its local photon
    shard and the per-round (d_nphot, d_tao) increments are all-reduced
    before the radius update, keeping hit-point state replicated
    (SURVEY.md section 2, photon-sharding axis).

    ``regen``: persistent photon lanes — dead lanes are refilled from the
    lights every segment and photon walks persist across rounds (see
    ``photon_trace_regen``).

    Returns (hp, emitted_per_light, deposits_dropped): the caller MUST
    normalise the image by ``emitted_per_light`` (static rounds * photons
    without regen); nonzero ``deposits_dropped`` means the compaction
    capacity clipped real flux — raise ``deposit_compact_frac``.
    """

    # Deposit backends with a ``prepare`` hook (ops/deposit_pallas.py) build
    # their round-invariant hit-point layout ONCE per pass, outside the scan.
    # Backends that ALSO expose ``packed_call`` run the whole rounds loop in
    # LAYOUT SPACE: per-pass state (r2, tao, nphot, wgt) is scattered into
    # the bucket-aligned layout once, every round's deposit + PPM update is
    # elementwise there, and the state unpacks once at pass end — no
    # per-round result gather or r2-refresh scatter.
    packed_mode = (hasattr(deposit_fn, "packed_call")
                   and hasattr(deposit_fn, "prepare"))
    dep_call = deposit_fn
    if hasattr(deposit_fn, "prepare"):
        with jax.named_scope("deposit"):
            prep = deposit_fn.prepare(hp)
        dep_call = partial(deposit_fn, prep=prep)

    # Opaque per-pass hit-point state for the rounds scan + its fold.
    if packed_mode:
        r2_pad, wgt_pad = deposit_fn.pack_state(hp, prep)
        c_pad = r2_pad.shape[0]
        g = prep.g
        nphot_pad = jnp.zeros((c_pad,), hp.nphot.dtype).at[g].set(
            hp.nphot, unique_indices=True, mode="drop")
        tao_pad = jnp.zeros((c_pad, 3), hp.tao.dtype).at[g].set(
            hp.tao, unique_indices=True, mode="drop")
        state0 = (r2_pad, tao_pad, nphot_pad)

        def fold_state(state, dep):
            r2_p, tao_p, nph_p = state
            with jax.named_scope("deposit"):
                cnt, fl = deposit_fn.packed_call(r2_p, dep, prep)
            d_tao = wgt_pad * fl / jnp.pi               # Raytracer.h:156
            if psum_axis is not None:
                cnt, d_tao = jax.lax.psum((cnt, d_tao), psum_axis)
            return ppm_update_arrays(r2_p, tao_p, nph_p, cnt, d_tao,
                                     update_mode)

        def finish_state(state):
            r2_p, tao_p, nph_p = state
            # Invalid lanes keep their original values (their layout slots
            # carry the r2 = -1 sentinel, not state).
            return hp.replace(
                r2=jnp.where(hp.valid, r2_p[g], hp.r2),
                tao=jnp.where(hp.valid[:, None], tao_p[g], hp.tao),
                nphot=jnp.where(hp.valid, nph_p[g], hp.nphot),
            )
    else:
        state0 = hp

        def fold_state(state, dep):
            with jax.named_scope("deposit"):
                d_n, d_tao = dep_call(state, dep)
            if psum_axis is not None:
                d_n, d_tao = jax.lax.psum((d_n, d_tao), psum_axis)
            return ppm_update(state, d_n, d_tao, update_mode)

        def finish_state(state):
            return state

    def compact(dep):
        """Compact + report overflow (deposits beyond capacity are LOST
        flux; a nonzero drop count means deposit_compact_frac is too low)."""
        dropped = jnp.zeros((), jnp.int32)
        if deposit_compact_frac < 1.0:
            cap = max(int(dep.valid.shape[0] * deposit_compact_frac), 128)
            nv = jnp.sum(dep.valid.astype(jnp.int32))
            dropped = jnp.maximum(nv - cap, 0)
            dep = compact_deposits(dep, cap)
        return dep, dropped

    keys = jax.random.split(key, n_rounds)

    if regen:
        pstate = regen_state_init(scene.light_pos.shape[0],
                                  photons_per_round)

        def round_body(carry, k):
            state, pstate, emitted, drops = carry
            dep, pstate, e = photon_trace_regen(
                scene, k, scene.light_pos, scene.light_color,
                photons_per_round, pstate, max_depth,
                debias_roulette=debias_roulette, newton_fn=newton_fn,
            )
            dep, dropped = compact(dep)
            state = fold_state(state, dep)
            return (state, pstate, emitted + e, drops + dropped), None

        L = scene.light_pos.shape[0]
        (state, _, emitted, drops), _ = jax.lax.scan(
            round_body,
            (state0, pstate, jnp.zeros((L,), jnp.float32),
             jnp.zeros((), jnp.int32)),
            keys,
        )
        # Per-light counts are equal to within one photon (round-robin
        # refill), so the scalar per-light normaliser is their mean.
        return finish_state(state), jnp.mean(emitted), drops

    def round_body(carry, k):
        state, drops = carry
        ke, kt = jax.random.split(k)
        org, dir, flux = emit_photons(
            ke, scene.light_pos, scene.light_color, photons_per_round
        )
        dep = photon_trace(scene, kt, org, dir, flux, max_depth,
                           debias_roulette=debias_roulette,
                           newton_fn=newton_fn)
        dep, dropped = compact(dep)
        state = fold_state(state, dep)
        return (state, drops + dropped), None

    (state, drops), _ = jax.lax.scan(
        round_body, (state0, jnp.zeros((), jnp.int32)), keys
    )
    return (finish_state(state),
            jnp.asarray(float(n_rounds * photons_per_round), jnp.float32),
            drops)


def estimate_image(hp: HitPoints, n_pixels: int, total_photons: int) -> jnp.ndarray:
    """Radiance per pixel from hit-point statistics.

    Reference: Raytracer.h:281-294: pic[px] += tao / (pi * r2 * cnt*onetime),
    summed over the pixel's hit points.  Returns (n_pixels, 3).
    """
    scale = jnp.where(
        hp.valid, 1.0 / (jnp.pi * hp.r2 * total_photons), 0.0
    )
    contrib = hp.tao * scale[:, None]
    img = jnp.zeros((n_pixels, 3), hp.tao.dtype)
    idx = jnp.where(hp.valid, hp.pixel, n_pixels)
    return img.at[idx].add(contrib, mode="drop")


def render_pass(
    scene: Scene,
    cam_org: jnp.ndarray,
    cam_dir: jnp.ndarray,
    key: jax.Array,
    hitpoint_capacity: int,
    n_rounds: int,
    photons_per_round: int,
    max_depth: int = MAX_DEPTH,
    slots: int = 1,
    init_r2: float = INIT_R2,
    update_mode: str = "sppm",
    deposit_fn=deposit_bruteforce,
    newton_fn=None,
    deposit_compact_frac: float = 1.0,
    debias_roulette: bool = False,
    photon_scene: Scene | None = None,
    photon_regen: bool = False,
    eye_compact_schedule: tuple = (),
):
    """One full SPPM pass: eye trace -> photon rounds -> pixel estimate.

    Reference: RayTracer::render (Raytracer.h:366-387).  Pure function of
    (scene params, camera rays, key) -> (image, stats); jit/vmap/grad-safe.

    Returns (image (R, 3), stats dict).
    """
    with jax.named_scope("eye_pass"):
        hp, stats = eye_pass(
            scene, cam_org, cam_dir, hitpoint_capacity, max_depth, slots,
            init_r2, newton_fn=newton_fn,
            compact_schedule=eye_compact_schedule,
        )
    # The photon pass may use different static tuning (e.g. a much smaller
    # Bezier ray-compaction fraction: photons hit the teapot AABB on ~1% of
    # segments vs ~4% of eye rays).
    with jax.named_scope("photon_rounds"):
        hp, emitted, dep_drops = photon_rounds(
            photon_scene if photon_scene is not None else scene,
            key, hp, n_rounds, photons_per_round, max_depth,
            update_mode, deposit_fn, newton_fn,
            deposit_compact_frac=deposit_compact_frac,
            debias_roulette=debias_roulette,
            regen=photon_regen,
        )
    img = estimate_image(hp, cam_org.shape[0], emitted)
    stats = dict(stats)
    stats["photons_emitted"] = emitted
    stats["deposits_dropped"] = dep_drops
    stats["mean_r2"] = jnp.sum(jnp.where(hp.valid, hp.r2, 0.0)) / jnp.maximum(
        jnp.sum(hp.valid.astype(jnp.int32)), 1
    )
    return img, stats


def tonemap(x: jnp.ndarray) -> jnp.ndarray:
    """Reference tone map + gamma (Raytracer.h:24-26):
    toInt(x) = floor((1 - e^-x)^(1/2.2) * 255 + 0.5), returned as uint8."""
    v = jnp.power(1.0 - jnp.exp(-jnp.maximum(x, 0.0)), 1.0 / 2.2)
    return jnp.clip(jnp.floor(v * 255.0 + 0.5), 0, 255).astype(jnp.uint8)
