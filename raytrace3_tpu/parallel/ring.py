"""Hit-point-sharded photon rounds with a ring exchange of deposits.

SURVEY.md section 2 parallel axis #3: "Hit-point sharding for large
canvases: shard hit points, all-gather/permute photons past shards
(ring-style exchange) — the renderer's analogue of ring attention;
needed only at 1024x1024+ with splitting (hitpoints > pixels)."

Memory layout vs parallel/shard.py: there the hit-point state is REPLICATED
in each pass group (fine up to ~10^6 hit points); here each device owns only
C/n hit points and the per-round DEPOSIT BATCH rotates around the ring via
``jax.lax.ppermute`` — n-1 hops overlap compute (the local deposit op) with
device-to-device transfers exactly like ring attention overlaps KV block
transfer with attention compute.  No psum of (C,)-sized tensors is needed at all: each
shard's (d_nphot, d_tao) increments are complete after the full rotation.

The tuned single-chip machinery all works hit-point-sharded (VERDICT round
4 item 7): persistent-lane ``regen`` walks are per-DEVICE state (each
device owns its photon lanes; only the deposit batches rotate), and
layout-space rounds (``prepare`` + ``packed_call`` backends) hold the local
shard's state packed for the whole pass — the per-hop deposit calls
accumulate raw (cnt, flux) in layout space and one elementwise PPM update
folds them per round.

All collectives are XLA-inserted; determinism: the accumulation order over
ring steps is fixed by the rotation schedule, so results are bitwise
reproducible for a given mesh size.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..core.types import Deposits, HitPoints
from ..geometry.scene import Scene
from ..render.deposit import deposit_bruteforce
from ..render.eye import MAX_DEPTH
from ..render.light import emit_photons
from ..render.photon import (compact_deposits, photon_trace,
                             photon_trace_regen, regen_state_init)
from ..render.sppm import ppm_update, ppm_update_arrays


def photon_rounds_ring(
    scene: Scene,
    key: jax.Array,
    hp_local: HitPoints,
    n_rounds: int,
    local_photons: int,
    axis_name: str,
    max_depth: int = MAX_DEPTH,
    update_mode: str = "sppm",
    deposit_fn=deposit_bruteforce,
    newton_fn=None,
    deposit_compact_frac: float = 1.0,
    debias_roulette: bool = False,
    regen: bool = False,
):
    """Photon rounds over hit-point shards (call inside shard_map).

    Args:
      hp_local: this device's hit-point shard (C/n records).
      local_photons: photons traced per device per round.
      axis_name: the mesh axis the hit points are sharded over.
    Returns (updated LOCAL hit-point shard, emitted_per_light,
    deposit drop count).  ``emitted_per_light`` counts THIS DEVICE's
    emissions (the caller psums over the ring axis for the image
    normaliser); it is the static rounds * local_photons without regen and
    the dynamic refill count with it, exactly like ``photon_rounds``.
    """
    n = jax.lax.axis_size(axis_name)
    me = jax.lax.axis_index(axis_name)
    perm = [(i, (i + 1) % n) for i in range(n)]

    # Backends with a prepare() hook (ops/deposit_pallas.py) amortise the
    # hit-point layout across all rounds x ring hops of the pass; with
    # packed_call too, the whole pass runs in LAYOUT SPACE (as in
    # photon_rounds).
    packed_mode = (hasattr(deposit_fn, "packed_call")
                   and hasattr(deposit_fn, "prepare"))
    raw_call = deposit_fn
    prep = None
    if hasattr(deposit_fn, "prepare"):
        prep = deposit_fn.prepare(hp_local)
        raw_call = partial(deposit_fn, prep=prep)

    if packed_mode:
        r2_pad, wgt_pad = deposit_fn.pack_state(hp_local, prep)
        c_pad = r2_pad.shape[0]
        g = prep.g
        nphot_pad = jnp.zeros((c_pad,), hp_local.nphot.dtype).at[g].set(
            hp_local.nphot, unique_indices=True, mode="drop")
        tao_pad = jnp.zeros((c_pad, 3), hp_local.tao.dtype).at[g].set(
            hp_local.tao, unique_indices=True, mode="drop")
        state0 = (r2_pad, tao_pad, nphot_pad)

        def dep_hop(state, acc, dep):
            cnt, fl = deposit_fn.packed_call(state[0], dep, prep)
            return (acc[0] + cnt, acc[1] + fl)

        def acc_init(state):
            r2_p = state[0]
            return (jnp.zeros_like(r2_p), jnp.zeros((c_pad, 3), r2_p.dtype))

        def fold_round(state, acc):
            r2_p, tao_p, nph_p = state
            cnt, fl = acc
            d_tao = wgt_pad * fl / jnp.pi               # Raytracer.h:156
            return ppm_update_arrays(r2_p, tao_p, nph_p, cnt, d_tao,
                                     update_mode)

        def finish_state(state):
            r2_p, tao_p, nph_p = state
            return hp_local.replace(
                r2=jnp.where(hp_local.valid, r2_p[g], hp_local.r2),
                tao=jnp.where(hp_local.valid[:, None], tao_p[g],
                              hp_local.tao),
                nphot=jnp.where(hp_local.valid, nph_p[g], hp_local.nphot),
            )
    else:
        state0 = hp_local

        def dep_hop(state, acc, dep):
            d_n, d_tao = raw_call(state, dep)
            return (acc[0] + d_n, acc[1] + d_tao)

        def acc_init(state):
            return (jnp.zeros(state.capacity, state.pos.dtype),
                    jnp.zeros((state.capacity, 3), state.pos.dtype))

        def fold_round(state, acc):
            d_n, d_tao = acc
            return ppm_update(state, d_n, d_tao, update_mode)

        def finish_state(state):
            return state

    def compact(dep):
        dropped = jnp.zeros((), jnp.int32)
        if deposit_compact_frac < 1.0:
            cap = max(int(dep.valid.shape[0] * deposit_compact_frac), 128)
            nv = jnp.sum(dep.valid.astype(jnp.int32))
            dropped = jnp.maximum(nv - cap, 0)
            dep = compact_deposits(dep, cap)
        return dep, dropped

    def ring_rotation(state, dep):
        """Full rotation: local deposit op x n, overlapping each hop."""
        def ring_step(carry, _):
            dep, acc = carry
            acc = dep_hop(state, acc, dep)             # local compute ...
            dep = jax.tree.map(
                lambda x: jax.lax.ppermute(x, axis_name, perm), dep
            )                                          # ... overlaps the hop
            return (dep, acc), None

        (_, acc), _ = jax.lax.scan(
            ring_step, (dep, acc_init(state)), None, length=n
        )
        return acc

    # Per-device keys: photon batches must differ across the ring axis.
    kshard = jax.random.fold_in(key, me)
    keys = jax.random.split(kshard, n_rounds)
    L = scene.light_pos.shape[0]

    if regen:
        pstate = regen_state_init(L, local_photons)

        def round_body(carry, k):
            state, pstate, emitted, drops = carry
            dep, pstate, e = photon_trace_regen(
                scene, k, scene.light_pos, scene.light_color,
                local_photons, pstate, max_depth,
                debias_roulette=debias_roulette, newton_fn=newton_fn,
            )
            dep, dropped = compact(dep)
            state = fold_round(state, ring_rotation(state, dep))
            return (state, pstate, emitted + e, drops + dropped), None

        (state, _, emitted, drops), _ = jax.lax.scan(
            round_body,
            (state0, pstate, jnp.zeros((L,), jnp.float32),
             jnp.zeros((), jnp.int32)),
            keys,
        )
        return finish_state(state), jnp.mean(emitted), drops

    def round_body(carry, k):
        state, drops = carry
        ke, kt = jax.random.split(k)
        org, dir, flux = emit_photons(
            ke, scene.light_pos, scene.light_color, local_photons
        )
        dep = photon_trace(scene, kt, org, dir, flux, max_depth,
                           debias_roulette=debias_roulette,
                           newton_fn=newton_fn)
        dep, dropped = compact(dep)
        state = fold_round(state, ring_rotation(state, dep))
        return (state, drops + dropped), None

    (state, drops), _ = jax.lax.scan(
        round_body, (state0, jnp.zeros((), jnp.int32)), keys
    )
    return (finish_state(state),
            jnp.asarray(float(n_rounds * local_photons), jnp.float32),
            drops)
