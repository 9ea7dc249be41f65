"""Ring-exchange (hit-point-sharded) photon rounds must equal the
replicated+psum formulation on the virtual 8-device mesh."""

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from raytrace3_tpu.parallel.mesh import PHOTON_AXIS, make_mesh
from raytrace3_tpu.parallel.ring import photon_rounds_ring
from raytrace3_tpu.render.camera import emit_rays, look_at
from raytrace3_tpu.render.driver import build_scene
from raytrace3_tpu.render.eye import eye_pass
from raytrace3_tpu.render.sppm import estimate_image, photon_rounds
from raytrace3_tpu.utils.config import RenderConfig

CFG = RenderConfig(
    scene="cornell_diffuse", width=16, height=16, rounds=2,
    photons_per_round=512, max_depth=4, atlas_res=16,
)


def test_ring_matches_replicated(key):
    scene = build_scene(CFG)
    mesh = make_mesh(1, 8)
    n = 8
    cam = look_at(jnp.asarray([50.0, 35.0, 230.0], jnp.float32),
                  jnp.asarray([50.0, 35.042612, 229.0], jnp.float32),
                  CFG.width, CFG.height)
    org, dirs = emit_rays(cam)
    R = CFG.n_pixels
    ray_shard = R // n
    local_cap = CFG.hitpoint_capacity // n
    local_photons = CFG.photons_per_round // n

    def ring_body(org_s, dir_s):
        fi = jax.lax.axis_index(PHOTON_AXIS)
        hp_local, _ = eye_pass(scene, org_s, dir_s, local_cap, CFG.max_depth,
                               pixel_offset=fi * ray_shard)
        hp_local, _emitted, _drops = photon_rounds_ring(
            scene, key, hp_local, CFG.rounds, local_photons, PHOTON_AXIS,
            CFG.max_depth, CFG.update_mode,
        )
        # image contribution from the local shard, summed over shards
        img = estimate_image(hp_local, R,
                             CFG.rounds * CFG.photons_per_round)
        return jax.lax.psum(img, PHOTON_AXIS)

    ring_img = jax.jit(jax.shard_map(
        ring_body, mesh=mesh, in_specs=(P(PHOTON_AXIS), P(PHOTON_AXIS)),
        out_specs=P(), check_vma=False,
    ))(org, dirs)

    # Replicated reference: same key schedule — photon_rounds_ring folds the
    # base key by shard index then splits per round (matching
    # photon_rounds' shape), each shard tracing local_photons photons.
    # Emulate: per round, concatenate the 8 shards' deposits (all against
    # the full hit-point set) before one update.
    from raytrace3_tpu.render.deposit import deposit_bruteforce
    from raytrace3_tpu.render.light import emit_photons
    from raytrace3_tpu.render.photon import photon_trace
    from raytrace3_tpu.render.sppm import ppm_update

    hps = [
        eye_pass(scene, org[i * ray_shard:(i + 1) * ray_shard],
                 dirs[i * ray_shard:(i + 1) * ray_shard], local_cap,
                 CFG.max_depth, pixel_offset=i * ray_shard)[0]
        for i in range(n)
    ]
    hp = jax.tree.map(lambda *xs: jnp.concatenate(xs, 0), *hps)
    rkeys = [jax.random.split(jax.random.fold_in(key, i), CFG.rounds)
             for i in range(n)]
    for r in range(CFG.rounds):
        d_n = jnp.zeros(hp.capacity)
        d_t = jnp.zeros((hp.capacity, 3))
        for i in range(n):
            ke, kt = jax.random.split(rkeys[i][r])
            po, pd, pf = emit_photons(ke, scene.light_pos,
                                      scene.light_color, local_photons)
            dep = photon_trace(scene, kt, po, pd, pf, CFG.max_depth)
            dn_i, dt_i = deposit_bruteforce(hp, dep)
            d_n += dn_i
            d_t += dt_i
        hp = ppm_update(hp, d_n, d_t, CFG.update_mode)
    want = estimate_image(hp, R, CFG.rounds * CFG.photons_per_round)

    np.testing.assert_allclose(np.asarray(ring_img), np.asarray(want),
                               rtol=2e-4, atol=1e-5)


def test_ring_regen_packed_matches_emulation(key):
    """The ring supports the TUNED machinery — persistent-lane regen and
    layout-space rounds (the banded deposit's prepare + packed_call) — and
    still equals the flat emulation: per round, every shard's regen
    deposits accumulate into each local hp shard (one full rotation) before
    a single PPM update."""
    from raytrace3_tpu.ops.deposit_pallas import BandedDeposit
    from raytrace3_tpu.render.deposit import deposit_bruteforce
    from raytrace3_tpu.render.photon import (photon_trace_regen,
                                             regen_state_init)
    from raytrace3_tpu.render.sppm import ppm_update

    scene = build_scene(CFG)
    mesh = make_mesh(1, 8)
    n = 8
    cam = look_at(jnp.asarray([50.0, 35.0, 230.0], jnp.float32),
                  jnp.asarray([50.0, 35.042612, 229.0], jnp.float32),
                  CFG.width, CFG.height)
    org, dirs = emit_rays(cam)
    R = CFG.n_pixels
    ray_shard = R // n
    local_cap = CFG.hitpoint_capacity // n
    local_photons = CFG.photons_per_round // n
    depo = BandedDeposit(tile=128, chunk=256, interpret=True, x_lo=-4.0,
                         x_hi=104.0)

    def ring_body(org_s, dir_s):
        fi = jax.lax.axis_index(PHOTON_AXIS)
        hp_local, _ = eye_pass(scene, org_s, dir_s, local_cap, CFG.max_depth,
                               pixel_offset=fi * ray_shard)
        hp_local, emitted, drops = photon_rounds_ring(
            scene, key, hp_local, CFG.rounds, local_photons, PHOTON_AXIS,
            CFG.max_depth, CFG.update_mode, deposit_fn=depo, regen=True,
        )
        total = jax.lax.psum(emitted, PHOTON_AXIS)
        img = estimate_image(hp_local, R, total)
        return (jax.lax.psum(img, PHOTON_AXIS),
                jax.lax.psum(drops, PHOTON_AXIS))

    ring_img, drops = jax.jit(jax.shard_map(
        ring_body, mesh=mesh, in_specs=(P(PHOTON_AXIS), P(PHOTON_AXIS)),
        out_specs=(P(), P()), check_vma=False,
    ))(org, dirs)
    assert int(drops) == 0

    hps = [
        eye_pass(scene, org[i * ray_shard:(i + 1) * ray_shard],
                 dirs[i * ray_shard:(i + 1) * ray_shard], local_cap,
                 CFG.max_depth, pixel_offset=i * ray_shard)[0]
        for i in range(n)
    ]
    hp = jax.tree.map(lambda *xs: jnp.concatenate(xs, 0), *hps)
    L = scene.light_pos.shape[0]
    rkeys = [jax.random.split(jax.random.fold_in(key, i), CFG.rounds)
             for i in range(n)]
    pstates = [regen_state_init(L, local_photons) for _ in range(n)]
    emitted_total = 0.0
    for r in range(CFG.rounds):
        d_n = jnp.zeros(hp.capacity)
        d_t = jnp.zeros((hp.capacity, 3))
        for i in range(n):
            dep, pstates[i], e = photon_trace_regen(
                scene, rkeys[i][r], scene.light_pos, scene.light_color,
                local_photons, pstates[i], CFG.max_depth,
            )
            emitted_total += float(jnp.mean(e))
            dn_i, dt_i = deposit_bruteforce(hp, dep)
            d_n += dn_i
            d_t += dt_i
        hp = ppm_update(hp, d_n, d_t, CFG.update_mode)
    want = estimate_image(hp, R, emitted_total)

    np.testing.assert_allclose(np.asarray(ring_img), np.asarray(want),
                               rtol=2e-4, atol=1e-5)
