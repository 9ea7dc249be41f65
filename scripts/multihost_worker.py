#!/usr/bin/env python
"""Multi-host smoke worker: one process of a 2-process jax.distributed run.

Exercises the real multi-host bootstrap (``parallel.mesh.multihost_init`` ->
``jax.distributed.initialize``) plus the renderer's sharded train step over
a GLOBAL mesh whose photon axis spans processes — the collectives (hit-point
all_gather, deposit psum, gradient all-reduce) ride the cross-process
backend (gloo on CPU; NCCL between GPU hosts with zero code changes).

The reference's only parallel seam is a single-process OpenMP loop
(raytracer/Raytracer.h:442-458); this is its multi-host replacement,
demonstrated end to end.

Usage (launched twice by tests/test_multihost.py):
  python scripts/multihost_worker.py <coordinator> <num_processes> <pid>
"""

from __future__ import annotations

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main() -> int:
    coordinator, num_processes, pid = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])

    import jax

    jax.config.update("jax_platforms", "cpu")
    # CPU cross-process collectives need the gloo implementation.
    jax.config.update("jax_cpu_collectives_implementation", "gloo")

    from raytrace3_tpu.parallel.mesh import make_mesh, multihost_init

    multihost_init(coordinator, num_processes, pid)
    assert jax.process_count() == num_processes, jax.process_count()

    import jax.numpy as jnp
    import numpy as np
    import optax
    from jax.experimental import multihost_utils
    from jax.sharding import NamedSharding, PartitionSpec as P

    from raytrace3_tpu.diff.train import extract_params, make_train_step
    from raytrace3_tpu.render.driver import build_scene
    from raytrace3_tpu.utils.config import RenderConfig

    n_dev = len(jax.devices())
    mesh = make_mesh(1, n_dev)  # photon axis spans BOTH processes

    cfg = RenderConfig(
        scene="bezier_patch", width=8, height=8, passes=1, rounds=1,
        photons_per_round=32 * n_dev, max_depth=3, atlas_res=8,
        bezier_compact_frac=1.0, newton_restarts=2, newton_iters=4,
        hitpoint_factor=2.0,
    )
    assert cfg.n_pixels % n_dev == 0
    scene = build_scene(cfg)

    init_fn, step_fn = make_train_step(scene, cfg, optax.adam(1e-2), mesh=mesh)
    params = extract_params(scene)
    opt_state = init_fn(params)
    target = jnp.zeros((cfg.height, cfg.width, 3))

    # Every step input is identical on both processes -> replicate it onto
    # the global mesh (process-local arrays can't feed a cross-process jit;
    # device_put can't target non-addressable shardings, so build global
    # arrays from the per-process copies).
    rep = NamedSharding(mesh, P())
    put = lambda t: jax.tree.map(
        lambda x: jax.make_array_from_process_local_data(rep, np.asarray(x)), t)
    params, opt_state, target = put(params), put(opt_state), put(target)
    key = put(jax.random.PRNGKey(0))  # raw uint32 key: plain-dtype global array

    params2, _, loss, _ = step_fn(params, opt_state, key, target)
    jax.block_until_ready(params2)

    # Both processes must see the same finite loss (psum'd over the mesh).
    # process_allgather can't gather a non-fully-addressable scalar; gather
    # each process's locally-read value instead.
    local = np.asarray(loss.addressable_data(0)).reshape(1)
    losses = np.asarray(multihost_utils.process_allgather(local, tiled=True))
    assert losses.shape == (num_processes,), losses.shape
    assert np.isfinite(losses).all(), losses
    assert np.allclose(losses, losses[0]), losses
    print(f"multihost OK pid={pid} procs={jax.process_count()} "
          f"devices={n_dev} loss={float(losses[0]):.6f}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
