"""Differentiability tests (BASELINE metric: "grad check pass rate"):
custom_vjp deposit vs plain AD vs finite differences; end-to-end pixel
gradients w.r.t. albedo / textures / control points; train-step smoke."""

import jax
import jax.numpy as jnp
import numpy as np

from raytrace3_tpu.core.types import Deposits, make_hitpoints
from raytrace3_tpu.diff.train import (
    extract_params,
    inject_params,
    make_render_fn,
    make_train_step,
)
from raytrace3_tpu.diff.vjp import deposit_bruteforce_vjp
from raytrace3_tpu.render.deposit import deposit_bruteforce
from raytrace3_tpu.render.driver import build_scene
from raytrace3_tpu.utils.config import RenderConfig

TINY = RenderConfig(
    scene="cornell_diffuse", width=12, height=12, passes=1, rounds=2,
    photons_per_round=256, max_depth=3, atlas_res=8,
)


def _case(rng, C=60, D=150):
    hp = make_hitpoints(C, 2.0)
    n = rng.normal(size=(C, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    hp = hp.replace(
        pos=jnp.asarray(rng.uniform(0, 10, (C, 3)).astype(np.float32)),
        n=jnp.asarray(n),
        wgt=jnp.asarray(rng.uniform(0, 1, (C, 3)).astype(np.float32)),
        valid=jnp.ones((C,), bool),
    )
    dn = rng.normal(size=(D, 3)).astype(np.float32)
    dn /= np.linalg.norm(dn, axis=-1, keepdims=True)
    dep = Deposits(
        pos=jnp.asarray(rng.uniform(0, 10, (D, 3)).astype(np.float32)),
        n=jnp.asarray(dn),
        flux=jnp.asarray(rng.uniform(0, 2, (D, 3)).astype(np.float32)),
        valid=jnp.ones((D,), bool),
    )
    return hp, dep


def test_custom_vjp_forward_matches_plain(rng):
    hp, dep = _case(rng)
    c1, t1 = deposit_bruteforce(hp, dep)
    c2, t2 = deposit_bruteforce_vjp(hp, dep)
    np.testing.assert_allclose(np.asarray(c1), np.asarray(c2), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(t1), np.asarray(t2), rtol=1e-5)


def test_custom_vjp_grad_matches_autodiff(rng):
    hp, dep = _case(rng)

    def loss_plain(wgt, flux):
        _, tao = deposit_bruteforce(hp.replace(wgt=wgt), dep.replace(flux=flux))
        return jnp.sum(jnp.sin(tao))

    def loss_vjp(wgt, flux):
        _, tao = deposit_bruteforce_vjp(
            hp.replace(wgt=wgt), dep.replace(flux=flux)
        )
        return jnp.sum(jnp.sin(tao))

    g1 = jax.grad(loss_plain, argnums=(0, 1))(hp.wgt, dep.flux)
    g2 = jax.grad(loss_vjp, argnums=(0, 1))(hp.wgt, dep.flux)
    np.testing.assert_allclose(np.asarray(g1[0]), np.asarray(g2[0]),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(np.asarray(g1[1]), np.asarray(g2[1]),
                               rtol=1e-4, atol=1e-6)


def test_custom_vjp_grad_matches_finite_difference(rng):
    hp, dep = _case(rng, C=30, D=60)

    def loss(flux):
        _, tao = deposit_bruteforce_vjp(hp, dep.replace(flux=flux))
        return jnp.sum(tao**2)

    g = np.asarray(jax.grad(loss)(dep.flux))
    eps = 1e-2
    checked = hit = 0
    f0 = dep.flux
    for j in [0, 7, 23, 41]:
        for c in range(3):
            fp = f0.at[j, c].add(eps)
            fm = f0.at[j, c].add(-eps)
            fd = (float(loss(fp)) - float(loss(fm))) / (2 * eps)
            checked += 1
            if abs(fd - g[j, c]) <= 2e-2 * max(1.0, abs(fd)):
                hit += 1
    assert hit / checked >= 0.9, (hit, checked)


def test_end_to_end_gradients_albedo_texture(key):
    """jax.grad(loss o render) w.r.t. albedo table + texture atlas is finite
    and nonzero; albedo FD check on a scalar perturbation."""
    scene = build_scene(TINY)
    render = make_render_fn(scene, TINY)
    params = extract_params(scene)
    target = jnp.zeros((TINY.n_pixels, 3))

    def loss(p):
        return jnp.mean((render(p, key) - target) ** 2)

    val, grads = jax.value_and_grad(loss)(params)
    assert np.isfinite(float(val))
    gd = np.asarray(grads["diff"])
    ga = np.asarray(grads["atlas"])
    assert np.isfinite(gd).all() and np.abs(gd).max() > 0
    assert np.isfinite(ga).all()

    # FD on a single albedo scalar (brightening the floor albedo must move
    # the loss in the direction AD predicts)
    eps = 1e-2
    p_plus = dict(params, diff=params["diff"].at[3, 0].add(eps))
    p_minus = dict(params, diff=params["diff"].at[3, 0].add(-eps))
    fd = (float(loss(p_plus)) - float(loss(p_minus))) / (2 * eps)
    ad = float(gd[3, 0])
    assert abs(fd - ad) <= 0.15 * max(abs(fd), abs(ad), 1e-4), (fd, ad)


def test_end_to_end_gradient_ctrl_points_fd(key):
    """d(image)/d(ctrl) on a CURVED patch, validated against central finite
    differences with common random numbers (the full metric, all backends +
    larger sample, lives in scripts/gradcheck.py -> GRADCHECK.json).
    A zero or wrong-signed gradient through the Newton IFT vjp fails here."""
    # 16 Newton starts (4 x 4): the budget this FD check was calibrated
    # with; the render path's 8-start budget is checked against a 64-start
    # oracle in tests/test_pallas.py and chip_smoke.py.
    cfg = TINY.replace(scene="bezier_patch", width=16, height=16,
                       rounds=2, photons_per_round=1024, max_depth=4,
                       bezier_compact_frac=1.0, newton_restarts=16)
    scene = build_scene(cfg)
    # Aim camera + light at the curved body patch (teapot patch 4 spans
    # x 12-20, y 3.6-9.6, z 112-120): at the reference pose the patch
    # subtends almost nothing at 16^2 and the gradient is legitimately ~0.
    scene = scene.replace(
        light_pos=jnp.asarray([[10.0, 18.0, 108.0]], jnp.float32))
    render = make_render_fn(scene, cfg,
                            camera_pose=((8.0, 8.0, 128.0),
                                         (16.0, 6.6, 116.0)))
    params = extract_params(scene)
    assert "ctrl" in params
    w = jax.random.uniform(jax.random.key(7), (cfg.n_pixels, 3),
                           minval=0.5, maxval=1.5)

    @jax.jit
    def loss(p):
        return jnp.sum(render(p, key) * w)

    g = np.asarray(jax.jit(jax.grad(loss))(params)["ctrl"])
    assert np.isfinite(g).all()
    assert np.abs(g).max() > 0, "ctrl gradient is identically zero"

    # FD-check the strongest coordinates ON THE DIFFERENTIABLE LOCUS with
    # the scripts/gradcheck.py methodology (round 4): three nested FD
    # windows; a coordinate is SCORED when any pair of the trio agrees
    # within 30% (a jump in an outer shell contaminates only the larger
    # eps; a jump inside the smallest window leaves no agreeing pair and
    # excludes the coordinate), and the agreeing pair's smaller-eps member
    # is the FD estimate.  Tolerance 0.4 = the measured f32 FD noise floor
    # at these eps (see gradcheck.py REL_TOL_CTRL) — the round-3 version
    # of this test used eps 2e-4 where the floor is ~30% of |ad| against a
    # 25% tolerance, and passed or failed on ulp-level reorderings.
    def fd_at(idx, eps):
        return (float(loss(dict(params, ctrl=params["ctrl"].at[idx].add(eps))))
                - float(loss(dict(params,
                                  ctrl=params["ctrl"].at[idx].add(-eps))))
                ) / (2 * eps)

    flat = np.argsort(-np.abs(g).ravel())[:8]
    smooth = passed = 0
    for fi in flat:
        idx = np.unravel_index(int(fi), g.shape)
        fh, f1, f2 = fd_at(idx, 2.5e-4), fd_at(idx, 5e-4), fd_at(idx, 1e-3)
        est = None
        for a, b in ((fh, f1), (f1, f2), (fh, f2)):
            if abs(a - b) <= 0.3 * max(abs(a), abs(b)) + 1e-3:
                est = a
                break
        if est is None:
            continue  # discontinuity inside every window
        smooth += 1
        ad = float(g[idx])
        if abs(est - ad) <= 0.4 * max(abs(est), abs(ad)) + 1e-3:
            passed += 1
    assert smooth >= 2, f"only {smooth} smooth coords of {len(flat)}"
    assert passed == smooth, (passed, smooth)


def test_train_step_reduces_loss(key):
    """A few optimisation steps on the floor albedo reduce MSE to a target
    rendered with a different albedo."""
    scene = build_scene(TINY)
    render = make_render_fn(scene, TINY)
    p_true = extract_params(scene)
    target = render(p_true, key).reshape(TINY.height, TINY.width, 3)

    p0 = dict(p_true, diff=p_true["diff"] * 0.5)
    import optax

    init_fn, step_fn = make_train_step(scene, TINY, optax.adam(5e-2))
    opt_state = init_fn(p0)
    params = p0
    losses = []
    for i in range(5):
        params, opt_state, loss, tstats = step_fn(params, opt_state, key,
                                                  target)
        losses.append(float(loss))
        assert int(tstats["deposits_dropped"]) == 0
    assert losses[-1] < losses[0], losses


def test_sharded_train_step_runs(key):
    """Sharded loss/grad under shard_map on the virtual mesh compiles, runs,
    and produces finite grads (gradient psum via AD transposition)."""
    from raytrace3_tpu.parallel.mesh import make_mesh

    cfg = TINY.replace(width=16, height=16)
    scene = build_scene(cfg)
    mesh = make_mesh(1, 8)
    import optax

    init_fn, step_fn = make_train_step(scene, cfg, optax.adam(1e-2), mesh=mesh)
    params = extract_params(scene)
    opt_state = init_fn(params)
    target = jnp.zeros((cfg.height, cfg.width, 3))
    params2, _, loss, tstats = step_fn(params, opt_state, key, target)
    assert np.isfinite(float(loss))
    assert np.isfinite(np.asarray(params2["diff"])).all()
    assert int(tstats["deposits_dropped"]) == 0


def test_default_deposit_vjp_selection(monkeypatch):
    """The training render's default deposit is the exact bruteforce custom
    VJP, whatever the platform's render deposit is."""
    import raytrace3_tpu.diff.train as train
    from raytrace3_tpu.diff.train import extract_params, make_render_fn
    from raytrace3_tpu.diff.vjp import deposit_bruteforce_vjp
    from raytrace3_tpu.utils.config import RenderConfig

    calls = []

    def spy(hp, dep):
        calls.append(dep.pos.shape)
        return deposit_bruteforce_vjp(hp, dep)

    monkeypatch.setattr(train, "deposit_bruteforce_vjp", spy)
    cfg = RenderConfig(scene="cornell_diffuse", width=8, height=8, rounds=1,
                       photons_per_round=64, max_depth=2, atlas_res=8)
    scene = build_scene(cfg)
    render = make_render_fn(scene, cfg)
    out = jax.eval_shape(render, extract_params(scene), jax.random.key(0))
    assert out.shape == (cfg.n_pixels, 3)
    assert calls, "the default deposit was not the bruteforce VJP"
