"""Newton winner-solver tests: the 8-start stratified jnp solver the render
path uses (``backends.select_backends``), against analytic roots and a
64-start oracle."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytrace3_tpu.geometry.bezier import (
    BezierObject,
    intersect_bezier,
    restart_dims,
    restart_grid,
    solve_winner,
    winner_root,
)
from raytrace3_tpu.scenes import _teapot_ctrl


@pytest.fixture(scope="module")
def solver():
    # 8 starts (2 x 4 grid): certified against a 64-start oracle in
    # docs/NEWTON_RESTARTS.json (~1% of rays pick a different valid root).
    return jax.jit(partial(solve_winner, restarts=8))


def _flat_patch():
    g = np.linspace(0, 1, 4)
    uu, vv = np.meshgrid(g, g, indexing="xy")
    return jnp.asarray(
        np.stack([uu, vv, np.full_like(uu, 2.0)], -1)[None], jnp.float32
    )


def test_flat_patch_analytic(solver):
    ctrl = _flat_patch()
    org = jnp.asarray([[0.3, 0.4, 0.0], [0.9, 0.1, 1.0], [2.0, 2.0, 0.0]],
                      jnp.float32)
    dir = jnp.asarray([[0.0, 0.0, 1.0]] * 3, jnp.float32)
    t, u, v, pid, hit = solver(org, dir, ctrl)
    assert bool(hit[0]) and bool(hit[1]) and not bool(hit[2])
    np.testing.assert_allclose(np.asarray(t)[:2], [2.0, 1.0], atol=1e-3)
    np.testing.assert_allclose(np.asarray(u)[:2], [0.3, 0.9], atol=1e-3)
    np.testing.assert_allclose(np.asarray(v)[:2], [0.4, 0.1], atol=1e-3)


def test_matches_jnp_winner_on_teapot(solver):
    """8 starts against a 64-start oracle on rays aimed at the teapot: no
    oracle hit is missed, and almost every hit finds the oracle's root."""
    ctrl = _teapot_ctrl()
    rng = np.random.default_rng(1)
    center = np.asarray(ctrl.reshape(-1, 3)).mean(0)
    org = np.tile(np.array([50.0, 35.0, 230.0], np.float32), (96, 1))
    targets = center + rng.normal(scale=14.0, size=(96, 3))
    d = (targets - org).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)

    tp, up, vp, pp, hp = solver(jnp.asarray(org), jnp.asarray(d), ctrl)
    tj, uj, vj, pj, hj = solve_winner(jnp.asarray(org), jnp.asarray(d), ctrl,
                                      restarts=64)
    hp, hj = np.asarray(hp), np.asarray(hj)
    assert not (hj & ~hp).any()          # no oracle hit missed
    both = hp & hj
    assert both.sum() > 5
    tdiff = np.abs(np.asarray(tp) - np.asarray(tj))[both] / np.asarray(
        tj)[both]
    assert (tdiff > 1e-3).mean() <= 0.05, tdiff


@pytest.mark.parametrize("n", [1, 2, 4, 8, 16])
def test_restart_grid_layout(n):
    """``n`` starts form a gu x gv grid of cell centres, gu the largest
    divisor of n not above sqrt(n), u-major (u0 = cell of the first axis)."""
    gu, gv = restart_dims(n)
    assert gu * gv == n and gu <= gv
    assert gu == max(k for k in range(1, int(n ** 0.5) + 1) if n % k == 0)
    got = np.asarray(restart_grid(n))
    assert got.shape == (n, 2)
    for i in range(gu):
        for j in range(gv):
            np.testing.assert_allclose(
                got[i * gv + j], [(i + 0.5) / gu, (j + 0.5) / gv], rtol=1e-6)


def test_winner_root_ift_gradient_matches_unrolled(solver):
    """IFT custom_vjp gradient (through the solver's forward) agrees with
    differentiating the unrolled jnp Newton iteration."""
    ctrl = _flat_patch()
    org = jnp.asarray([[0.4, 0.6, 0.0]], jnp.float32)
    dir = jnp.asarray([[0.0, 0.0, 1.0]], jnp.float32)

    def t_ift(c):
        t, u, v, pid, hit = winner_root(org, dir, c, solver)
        return t[0]

    def t_unrolled(c):
        from raytrace3_tpu.geometry.bezier import newton_patch_solve

        t, _, _, _ = newton_patch_solve(org, dir, c)
        return t[0, 0]

    g1 = np.asarray(jax.grad(t_ift)(ctrl))
    g2 = np.asarray(jax.grad(t_unrolled)(ctrl))
    assert np.isfinite(g1).all()
    np.testing.assert_allclose(g1, g2, rtol=1e-2, atol=1e-4)


def test_intersect_bezier_with_pallas_backend(solver):
    """The scene-level entry point accepts a ``newton_fn`` solver and agrees
    with its default solver."""
    obj = BezierObject(ctrl=_teapot_ctrl())
    rng = np.random.default_rng(3)
    center = np.asarray(obj.ctrl.reshape(-1, 3)).mean(0)
    org = np.tile(np.array([50.0, 35.0, 230.0], np.float32), (32, 1))
    targets = center + rng.normal(scale=10.0, size=(32, 3))
    d = (targets - org).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)

    t1, h1, u1, v1, n1 = intersect_bezier(jnp.asarray(org), jnp.asarray(d),
                                          obj, newton_fn=solver)
    t2, h2, u2, v2, n2 = intersect_bezier(jnp.asarray(org), jnp.asarray(d),
                                          obj)
    h1, h2 = np.asarray(h1), np.asarray(h2)
    assert (h1 == h2).all()
    both = h1 & h2
    np.testing.assert_allclose(np.asarray(t1)[both], np.asarray(t2)[both],
                               atol=1e-3)
    np.testing.assert_allclose(np.asarray(n1)[both], np.asarray(n2)[both],
                               atol=1e-2)
