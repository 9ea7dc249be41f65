"""Differentiable rendering + inverse-rendering train step.

BASELINE.json's north star: ``jax.grad(loss o render)`` w.r.t. material
albedos, texture maps and Bezier control points, with gradient all-reduce
over the mesh overlapped with the backward pass (XLA schedules the psum
inserted by shard_map AD transposition).

Learnable parameters (a plain pytree pulled from / injected into a Scene):
  * ``diff``  — (N, 3) diffuse albedo table     (reference Material.diff)
  * ``atlas`` — (T, H, W, 3) texture maps       (reference Texture grids)
  * ``ctrl``  — (B, 4, 4, 3) Bezier control pts (reference Bezier3::P)
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import optax

from ..geometry.bezier import BezierObject
from ..geometry.scene import Scene
from ..render.camera import emit_rays, look_at
from ..render.sppm import render_pass
from ..utils.config import RenderConfig
from .vjp import deposit_bruteforce_vjp


def extract_params(scene: Scene) -> dict:
    p = {"diff": scene.materials.diff, "atlas": scene.atlas}
    if scene.has_bezier:
        p["ctrl"] = scene.bezier.ctrl
    return p


def inject_params(scene: Scene, params: dict) -> Scene:
    scene = scene.replace(
        materials=scene.materials.replace(diff=params["diff"]),
        atlas=params["atlas"],
    )
    if "ctrl" in params and scene.has_bezier:
        scene = scene.replace(bezier=BezierObject(ctrl=params["ctrl"]))
    return scene


def make_render_fn(scene: Scene, cfg: RenderConfig, camera_pose=None,
                   newton_fn=None, deposit_fn=None,
                   with_drops: bool = False):
    """(params, key) -> (H*W, 3) differentiable image.

    ``with_drops``: also return the pass's ``deposits_dropped`` counter —
    on the gradient path deposits clipped by ``deposit_compact_frac`` drop
    real flux AND the corresponding gradient contributions, so training
    entry points surface it."""
    if camera_pose is None:
        import numpy as np

        pos = np.array([50.0, 35.0, 230.0])
        look = pos + np.array([0.0, 0.042612, -1.0])
    else:
        pos, look = camera_pose
    cam = look_at(jnp.asarray(pos, jnp.float32), jnp.asarray(look, jnp.float32),
                  cfg.width, cfg.height)
    org, dir = emit_rays(cam)
    if deposit_fn is None:
        deposit_fn = deposit_bruteforce_vjp

    def render(params, key):
        s = inject_params(scene, params)
        img, stats = render_pass(
            s, org, dir, key,
            hitpoint_capacity=cfg.hitpoint_capacity,
            n_rounds=cfg.rounds,
            photons_per_round=cfg.photons_per_round,
            max_depth=cfg.max_depth,
            slots=cfg.slots,
            init_r2=cfg.init_r2,
            update_mode=cfg.update_mode,
            deposit_fn=deposit_fn,
            newton_fn=newton_fn,
        )
        if with_drops:
            return img, stats["deposits_dropped"]
        return img

    return render


def make_train_step(scene: Scene, cfg: RenderConfig, optimizer=None,
                    camera_pose=None, newton_fn=None, deposit_fn=None,
                    mesh=None):
    """Build (init_fn, step_fn) for inverse rendering.

    step_fn(params, opt_state, key, target)
        -> (params, opt_state, loss, stats)
    where ``stats["deposits_dropped"]`` is the forward pass's dropped-flux
    counter.  A nonzero value means the deposit compaction clipped real
    flux AND its gradient contributions — the gradient is silently biased,
    so the counter is surfaced from every train entry point rather than
    swallowed; callers should treat nonzero as a configuration error and
    raise ``deposit_compact_frac``.

    With ``mesh`` given, the loss is computed under ``shard_map`` with
    photons sharded over the PHOTON axis; AD transposition inserts the
    gradient psum (the all-reduce the reference never had).
    """
    if optimizer is None:
        optimizer = optax.adam(1e-2)

    if mesh is None:
        render = make_render_fn(scene, cfg, camera_pose, newton_fn,
                                deposit_fn, with_drops=True)

        def loss_fn(params, key, target):
            img, drops = render(params, key)
            return jnp.mean((img - target.reshape(-1, 3)) ** 2), drops
    else:
        loss_fn = _make_sharded_loss(scene, cfg, mesh, camera_pose,
                                     newton_fn, deposit_fn)

    @jax.jit
    def step_fn(params, opt_state, key, target):
        (loss, drops), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params, key, target)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss, {"deposits_dropped": drops}

    def init_fn(params):
        return optimizer.init(params)

    return init_fn, step_fn


def _make_sharded_loss(scene: Scene, cfg: RenderConfig, mesh, camera_pose,
                       newton_fn, deposit_fn):
    """Loss with eye rays + photons sharded over the mesh PHOTON axis.

    Runs the pass under shard_map: hit points all-gathered after the eye
    pass, per-round deposits psum'd (forward), and parameter gradients
    automatically all-reduced by the transpose of those collectives
    (backward) — the standard 'DP gradient psum' pattern mapped onto SPPM.
    """
    import numpy as np
    from jax.sharding import PartitionSpec as P

    from ..parallel.mesh import PASS_AXIS, PHOTON_AXIS
    from ..render.eye import eye_pass
    from ..render.sppm import estimate_image, photon_rounds

    if camera_pose is None:
        pos = np.array([50.0, 35.0, 230.0])
        look = pos + np.array([0.0, 0.042612, -1.0])
    else:
        pos, look = camera_pose
    cam = look_at(jnp.asarray(pos, jnp.float32),
                  jnp.asarray(look, jnp.float32), cfg.width, cfg.height)
    org, dir = emit_rays(cam)
    n_photon = mesh.shape[PHOTON_AXIS]
    R = cfg.n_pixels
    ray_shard = R // n_photon
    local_capacity = cfg.hitpoint_capacity // n_photon
    local_photons = cfg.photons_per_round // n_photon
    dep_fn = deposit_fn or deposit_bruteforce_vjp

    def loss_fn(params, key, target):
        # params/key/target enter through in_specs (replicated) rather than
        # closure capture: explicitly-sharded global inputs (multi-host) that
        # are captured inside the Manual shard_map context trip the
        # Auto-vs-Manual mesh check in sharding-in-types propagation.
        def body(params, key, target, org_s, dir_s):
            s = inject_params(scene, params)
            # Each pass-group minimises the loss of its own jittered-key
            # sample (the reference's 4 parallel passes, Raytracer.h:442);
            # group losses pmean over the pass axis, so parameter gradients
            # all-reduce over BOTH mesh axes via AD transposition.
            pi = jax.lax.axis_index(PASS_AXIS)
            fi = jax.lax.axis_index(PHOTON_AXIS)
            kpass = jax.random.fold_in(key, pi)
            hp_local, _ = eye_pass(
                s, org_s, dir_s, local_capacity, cfg.max_depth, cfg.slots,
                cfg.init_r2, newton_fn=newton_fn,
                pixel_offset=fi * ray_shard,
            )
            hp = jax.tree.map(
                lambda x: jax.lax.all_gather(x, PHOTON_AXIS, axis=0,
                                             tiled=True),
                hp_local,
            )
            hp, _, drops = photon_rounds(
                s, jax.random.fold_in(kpass, fi), hp, cfg.rounds,
                local_photons, cfg.max_depth, cfg.update_mode, dep_fn,
                newton_fn, psum_axis=PHOTON_AXIS,
            )
            img = estimate_image(hp, R, cfg.rounds * cfg.photons_per_round)
            loss = jnp.mean((img - target.reshape(-1, 3)) ** 2)
            # Total dropped deposits across the whole mesh (loud overflow).
            drops = jax.lax.psum(jax.lax.psum(drops, PHOTON_AXIS), PASS_AXIS)
            return jax.lax.pmean(loss, PASS_AXIS), drops

        return jax.shard_map(
            body, mesh=mesh,
            in_specs=(P(), P(), P(), P(PHOTON_AXIS), P(PHOTON_AXIS)),
            out_specs=P(), check_vma=False,
        )(params, key, target, org, dir)

    return loss_fn
