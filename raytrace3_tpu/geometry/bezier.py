"""Cubic Bezier patches: Bernstein evaluation, batched Newton intersection.

Reference: ``Bezier3`` / ``Bezier3Obj`` (raytracer/Bezier.h:59-289).  The
reference solves ray(t) = S(u,v) per candidate ray with 50 RANDOM restarts x
10 Newton steps, inverting the 3x3 Jacobian with OpenCV (Bezier.h:112-159).

Batched redesign (SURVEY.md C9-C11):
  * control points are a ``(B, 4, 4, 3)`` array — a differentiable parameter;
  * Bernstein evaluation is a tensor-product contraction (einsum);
  * Newton runs as a fixed-iteration batch over (rays x patches x restarts)
    with a DETERMINISTIC stratified (u, v) restart grid (same coverage as the
    reference's random restarts, none of the RNG divergence) and the
    closed-form Cramer solve from ops/solve3.py; XLA fuses the elementwise
    iteration on every backend;
  * acceptance mirrors Bezier.h:135: residual^2 < M_EPS and u, v in [0, 1];
    roots with t <= M_EPS are discarded up front (the reference instead lets
    a negative-t root win the per-patch min and then drops the whole patch at
    Bezier.h:251 — an accuracy bug we do not reproduce).

The solve is differentiated through :func:`winner_root` (implicit function
theorem), never through the unrolled iterations.
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..core.pytree import pytree_dataclass
from ..core.vecmath import M_EPS, MAX_DIST, normalize
from ..ops.compact import compact_indices
from ..ops.solve3 import solve3_columns
from .aabb import aabb_from_points, slab_test

#: Reference Newton iteration budget (Bezier.h:6 ``MAX_ITER 10``).
DEFAULT_NEWTON_ITERS = 10
#: Newton starts per ray-patch pair, laid out as a stratified gu x gv grid
#: (:func:`restart_grid`); they replace the reference's ``maxIter*5`` = 50
#: random restarts (Bezier.h:115).  8 (2 x 4) is the estimator certified
#: against a 64-start oracle (docs/NEWTON_RESTARTS.json: no missed eye hits,
#: ~1% of rays pick a different valid root).
DEFAULT_RESTARTS = 8


@pytree_dataclass
class BezierObject:
    """One Bezier object = a bag of bicubic patches (the teapot: B=32)."""

    ctrl: jnp.ndarray  # (B, 4, 4, 3); ctrl[b, i, k] pairs i with the v basis
    #                    and k with the u basis, matching the reference's
    #                    P[4i+k] layout (Bezier.h:85-90, 213-224).

    @property
    def num_patches(self) -> int:
        return self.ctrl.shape[0]


def bernstein(t: jnp.ndarray) -> jnp.ndarray:
    """Cubic Bernstein basis, (...,) -> (..., 4) (Bezier.h:69-76)."""
    s = 1.0 - t
    return jnp.stack([s * s * s, 3.0 * t * s * s, 3.0 * t * t * s, t * t * t], axis=-1)


def dbernstein(t: jnp.ndarray) -> jnp.ndarray:
    """Cubic Bernstein basis derivative, (...,) -> (..., 4) (Bezier.h:77-84)."""
    s = 1.0 - t
    return jnp.stack(
        [
            -3.0 * s * s,
            3.0 * s * s - 6.0 * t * s,
            6.0 * t * s - 3.0 * t * t,
            3.0 * t * t,
        ],
        axis=-1,
    )


def patch_point(ctrl: jnp.ndarray, u: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """S(u, v) for ctrl (..., 4, 4, 3), u/v (...,) -> (..., 3).

    Reference: evalPatchPoint (Bezier.h:85-90): S = b(v)^T G b(u)."""
    bu = bernstein(u)
    bv = bernstein(v)
    return jnp.einsum("...i,...k,...ikc->...c", bv, bu, ctrl, precision=jax.lax.Precision.HIGHEST)


def patch_derivs(ctrl: jnp.ndarray, u: jnp.ndarray, v: jnp.ndarray):
    """(S, dS/du, dS/dv) in one basis evaluation (Bezier.h:85-111).

    Both mixed derivatives contract the (..., 4, 4, 3) control tensor ONCE
    down to (..., 4, 3) and finish with a cheap 4-vector contraction — the
    one-shot 3-operand ``dbv, bu, ctrl`` einsum for Sv profiled 3.7x the
    two-step form at bench shapes (49.7 vs 13.4 ms/pass, round-4 trace)."""
    bu, bv = bernstein(u), bernstein(v)
    dbu, dbv = dbernstein(u), dbernstein(v)
    # Contract the v basis once, reuse for S and Su.
    gv = jnp.einsum("...i,...ikc->...kc", bv, ctrl, precision=jax.lax.Precision.HIGHEST)      # (..., 4, 3)
    s = jnp.einsum("...k,...kc->...c", bu, gv, precision=jax.lax.Precision.HIGHEST)
    su = jnp.einsum("...k,...kc->...c", dbu, gv, precision=jax.lax.Precision.HIGHEST)
    hv = jnp.einsum("...i,...ikc->...kc", dbv, ctrl, precision=jax.lax.Precision.HIGHEST)     # (..., 4, 3)
    sv = jnp.einsum("...k,...kc->...c", bu, hv, precision=jax.lax.Precision.HIGHEST)
    return s, su, sv


def patch_tangents(ctrl: jnp.ndarray, u: jnp.ndarray, v: jnp.ndarray):
    """(dS/du, dS/dv) only — the winner-normal path (Bezier.h:267-272)
    never needs S itself."""
    bu, bv = bernstein(u), bernstein(v)
    dbu, dbv = dbernstein(u), dbernstein(v)
    gv = jnp.einsum("...i,...ikc->...kc", bv, ctrl, precision=jax.lax.Precision.HIGHEST)
    su = jnp.einsum("...k,...kc->...c", dbu, gv, precision=jax.lax.Precision.HIGHEST)
    hv = jnp.einsum("...i,...ikc->...kc", dbv, ctrl, precision=jax.lax.Precision.HIGHEST)
    sv = jnp.einsum("...k,...kc->...c", bu, hv, precision=jax.lax.Precision.HIGHEST)
    return su, sv


def restart_dims(n: int) -> tuple[int, int]:
    """(gu, gv) with gu * gv = n and gu the largest divisor <= sqrt(n)."""
    if n < 1:
        raise ValueError(f"need at least one Newton start, got {n}")
    gu = math.isqrt(n)
    while n % gu:
        gu -= 1
    return gu, n // gu


def restart_grid(n: int, dtype=jnp.float32) -> jnp.ndarray:
    """``n`` stratified (u0, v0) cell centres of a gu x gv grid, u-major,
    shape (n, 2)."""
    gu, gv = restart_dims(n)
    cu = (np.arange(gu) + 0.5) / gu
    cv = (np.arange(gv) + 0.5) / gv
    uu, vv = np.meshgrid(cu, cv, indexing="ij")
    return jnp.asarray(np.stack([uu.ravel(), vv.ravel()], axis=-1), dtype)


def newton_patch_solve(
    org: jnp.ndarray,
    dir: jnp.ndarray,
    ctrl: jnp.ndarray,
    iters: int = DEFAULT_NEWTON_ITERS,
    restarts: int = DEFAULT_RESTARTS,
    residual2_eps: float = M_EPS,
    uv_slack: float = 0.0,
):
    """Batched Newton root-find of ``org + t dir = S(u, v)``.

    Args:
      org, dir: (R, 3) rays (dir need not be unit; the reference passes unit).
      ctrl:     (B, 4, 4, 3) patches.
      iters:    fixed Newton iterations (reference: 10, Bezier.h:115-140).
      restarts: number of stratified starts (:func:`restart_grid`).
    Returns:
      t:  (R, B) min accepted distance per ray-patch (MAX_DIST if none),
      u, v: (R, B) surface parameters of the winning root,
      hit: (R, B) bool.

    Acceptance per iteration mirrors Bezier.h:133-139: after each update,
    re-evaluate the residual at the NEW x and accept when residual^2 <
    residual2_eps and u, v in [0, 1] (+slack); the running min over
    (iteration, restart) replaces the reference's xvec + linear min scan
    (Bezier.h:142-158).
    """
    R = org.shape[0]
    B = ctrl.shape[0]
    starts = restart_grid(restarts, org.dtype)          # (G, 2)
    G = starts.shape[0]

    # Broadcast to the full (R, B, G) batch.
    o = org[:, None, None, :]
    d = dir[:, None, None, :]
    c = ctrl[None, :, None]                             # (1, B, 1, 4, 4, 3)
    u = jnp.broadcast_to(starts[None, None, :, 0], (R, B, G))
    v = jnp.broadcast_to(starts[None, None, :, 1], (R, B, G))
    # t0: project the start point onto the ray (better than the reference's
    # t0 = 0, Bezier.h:117, and costs one extra patch eval).
    s0 = patch_point(c, u, v)
    t = jnp.sum((s0 - o) * d, axis=-1) / jnp.sum(d * d, axis=-1)

    best_t = jnp.full((R, B, G), MAX_DIST, org.dtype)
    best_u = jnp.zeros((R, B, G), org.dtype)
    best_v = jnp.zeros((R, B, G), org.dtype)

    def body(carry, _):
        t, u, v, best_t, best_u, best_v = carry
        s, su, sv = patch_derivs(c, u, v)
        r = (o + t[..., None] * d) - s                  # residual F(x)
        dt, du, dv, ok = solve3_columns(
            jnp.broadcast_to(d, r.shape), -su, -sv, -r
        )
        # Clamp the update and the iterate: diverging restarts otherwise
        # overflow in masked-out lanes, and reverse-mode AD turns those
        # inf * 0 products into NaN gradients (the accept mask can't save
        # the backward pass).  Bounds are far outside any accepted root.
        dt = jnp.clip(dt, -1e4, 1e4)
        du = jnp.clip(du, -8.0, 8.0)
        dv = jnp.clip(dv, -8.0, 8.0)
        t2 = jnp.clip(t + jnp.where(ok, dt, 0.0), -1e4, 1e4)
        u2 = jnp.clip(u + jnp.where(ok, du, 0.0), -8.0, 8.0)
        v2 = jnp.clip(v + jnp.where(ok, dv, 0.0), -8.0, 8.0)
        # Re-evaluate residual at the new point (Bezier.h:133-135).
        s_new = patch_point(c, u2, v2)
        res2 = jnp.sum(((o + t2[..., None] * d) - s_new) ** 2, axis=-1)
        lo, hi = -uv_slack, 1.0 + uv_slack
        accept = (
            (res2 < residual2_eps)
            & (u2 >= lo) & (u2 <= hi)
            & (v2 >= lo) & (v2 <= hi)
            & (t2 > M_EPS)
            & (t2 < best_t)
        )
        best_t = jnp.where(accept, t2, best_t)
        best_u = jnp.where(accept, u2, best_u)
        best_v = jnp.where(accept, v2, best_v)
        return (t2, u2, v2, best_t, best_u, best_v), None

    (t, u, v, best_t, best_u, best_v), _ = jax.lax.scan(
        body, (t, u, v, best_t, best_u, best_v), None, length=iters
    )

    # Reduce over restarts.
    gi = jnp.argmin(best_t, axis=-1)                    # (R, B)
    take = lambda a: jnp.take_along_axis(a, gi[..., None], axis=-1)[..., 0]
    t_rb = take(best_t)
    return t_rb, take(best_u), take(best_v), t_rb < MAX_DIST


def solve_winner(org: jnp.ndarray, dir: jnp.ndarray, ctrl: jnp.ndarray,
                 iters: int = DEFAULT_NEWTON_ITERS,
                 restarts: int = DEFAULT_RESTARTS,
                 patch_prune: bool = True):
    """Winner-contract solver: nearest root over ALL patches per ray.

    Returns (t, u, v, patch_id, hit), each (R,).  This is the contract a
    ``newton_fn`` implements, and what :func:`winner_root` differentiates
    via the implicit function theorem.
    """
    t, u, v, hit = newton_patch_solve(org, dir, ctrl, iters, restarts)
    if patch_prune:
        pmin, pmax = aabb_from_points(ctrl.reshape(ctrl.shape[0], 16, 3))
        gate = slab_test(org[:, None, :], dir[:, None, :], pmin[None],
                         pmax[None])
        hit = hit & gate
    t = jnp.where(hit, t, MAX_DIST)
    bi = jnp.argmin(t, axis=-1).astype(jnp.int32)
    rows = jnp.arange(t.shape[0])
    t_b = t[rows, bi]
    return t_b, u[rows, bi], v[rows, bi], bi, t_b < MAX_DIST


@partial(jax.custom_vjp, nondiff_argnums=(3,))
def winner_root(org, dir, ctrl, solver):
    """Differentiable wrapper around any winner-contract solver.

    Forward: run ``solver`` (which need not be differentiable).
    Backward: the implicit function theorem at the root —
    F(x; th) = org + t dir - S(u, v; ctrl) = 0 gives
    th_bar = -(dF/dth)^T J^-T x_bar with J = [dir | -Su | -Sv].
    This replaces differentiating through iters x restarts unrolled Newton
    steps (SURVEY.md hard part (b)): O(1) memory, exact at the root.
    """
    return solver(org, dir, ctrl)


def _winner_fwd(org, dir, ctrl, solver):
    out = solver(org, dir, ctrl)
    return out, (org, dir, ctrl, out)


def _winner_bwd(solver, res, cots):
    org, dir, ctrl, (t, u, v, pid, hit) = res
    g_t, g_u, g_v, _, _ = cots
    live = hit
    zero = jnp.zeros_like(t)
    g = jnp.stack([jnp.where(live, g_t, 0.0),
                   jnp.where(live, g_u, 0.0),
                   jnp.where(live, g_v, 0.0)], axis=-1)     # (R, 3) = x_bar

    cw = ctrl[pid]                                          # (R, 4, 4, 3)
    # NB: linearise at the root AS RETURNED by the forward solver — the
    # cotangents correspond to the forward computation's (t, u, v), so
    # "polishing" the root here only degrades FD agreement (measured:
    # 2 extra Newton steps dropped the grad-check rate from 0.89 to 0.70).
    _, su, sv = patch_derivs(cw, u, v)
    # w = J^-T x_bar: solve J^T w = x_bar; rows of J^T are J's columns.
    # J columns: c0 = dir, c1 = -su, c2 = -sv; J^T w = (c0.w, c1.w, c2.w).
    # Solve via Cramer on the transposed system = solve3 with ROWS as the
    # matrix -> equivalent to solving with columns of J^T, i.e. the rows of
    # J: r0 = (dir_x, -su_x, -sv_x) etc.
    r0 = jnp.stack([dir[..., 0], -su[..., 0], -sv[..., 0]], -1)
    r1 = jnp.stack([dir[..., 1], -su[..., 1], -sv[..., 1]], -1)
    r2 = jnp.stack([dir[..., 2], -su[..., 2], -sv[..., 2]], -1)
    w0, w1, w2, ok = solve3_columns(r0, r1, r2, g)
    w = jnp.stack([w0, w1, w2], -1)                         # (R, 3)
    w = jnp.where((live & ok)[:, None], w, 0.0)

    # th_bar = -(dF/dth)^T w, F = org + t dir - S(u, v, ctrl).
    d_org = -w
    d_dir = -t[:, None] * w
    # dF/dctrl = -dS/dctrl -> d_ctrl = +(dS/dctrl)^T w, scattered per patch.
    bu, bv = bernstein(u), bernstein(v)                     # (R, 4)
    # S_c = sum_ik bv_i bu_k ctrl[pid, i, k, c]
    contrib = (bv[:, :, None, None] * bu[:, None, :, None]
               * w[:, None, None, :])                       # (R, 4, 4, 3)
    d_ctrl = jnp.zeros_like(ctrl).at[pid].add(contrib)
    return d_org, d_dir, d_ctrl


winner_root.defvjp(_winner_fwd, _winner_bwd)


def intersect_bezier(
    org: jnp.ndarray,
    dir: jnp.ndarray,
    obj: BezierObject,
    iters: int = DEFAULT_NEWTON_ITERS,
    restarts: int = DEFAULT_RESTARTS,
    patch_prune: bool = True,
    newton_fn=None,
    compact_frac: float = 1.0,
):
    """Nearest ray-object hit over all patches.

    Mirrors Bezier3Obj::GetIntersect (Bezier.h:240-282): object AABB gate,
    per-patch solve (per-patch AABB gate at Bezier.h:176-186 becomes a mask
    that zeroes pruned lanes), min-t reduce, normal = Su x Sv flipped toward
    the viewer.

    ``compact_frac`` < 1 enables RAY COMPACTION: only rays whose slab test
    passes the object AABB are gathered (static capacity = frac * R) and run
    through Newton; results scatter back.  The reference gets the same
    pruning for free from its per-ray branch (Bezier.h:244); in a batched
    program masking alone saves nothing, so we compact.  Overflowing rays
    beyond the capacity are treated as misses (size the fraction generously: the
    teapot subtends well under 25% of either pass's rays).

    Returns (t, hit, u, v, n): t (R,), hit (R,), u/v (R,), n (R, 3).
    ``newton_fn``: a winner-contract solver (org, dir, ctrl) ->
    (t, u, v, patch_id, hit); defaults to :func:`solve_winner`.  Either way
    the solve is wrapped in :func:`winner_root`, so gradients flow via the implicit function theorem
    regardless of backend.
    """
    R = org.shape[0]
    ctrl = obj.ctrl
    flat = ctrl.reshape(obj.num_patches, 16, 3)
    pmin, pmax = aabb_from_points(flat)                 # (B, 3) each
    obj_gate = slab_test(org, dir, jnp.min(pmin, 0), jnp.max(pmax, 0))

    solver = newton_fn if newton_fn is not None else partial(
        solve_winner, iters=iters, restarts=restarts, patch_prune=patch_prune
    )

    def winner_normal(d, u, v, pid):
        # Normal at the winning root only (Bezier.h:267-272), flipped
        # toward the viewer.
        cw = ctrl[pid]                                  # (r, 4, 4, 3)
        su, sv = patch_tangents(cw, u, v)
        n = jnp.cross(su, sv)
        n = jnp.where(jnp.sum(n * d, -1, keepdims=True) > 0.0, -n, n)
        return normalize(n)

    cap = R if compact_frac >= 1.0 else max(8, int(R * compact_frac))
    if cap < R:
        idx = compact_indices(obj_gate, cap, fill=R)              # (cap,)
        safe = jnp.minimum(idx, R - 1)
        # ONE packed (cap, 8)-row gather / scatter instead of per-field
        # ones: gather & scatter cost is per INDEX, so packing the lanes
        # into rows divides it by the field count (profiled: the separate
        # t/u/v/hit/n scatters alone were ~90 ms/pass at 512^2).
        od_c = jnp.concatenate([org, dir], axis=1)[safe]          # (cap, 6)
        org_c, dir_c = od_c[:, 0:3], od_c[:, 3:6]
        with jax.named_scope("newton"):
            t_c, u_c, v_c, pid_c, hit_c = winner_root(
                org_c, dir_c, ctrl, solver
            )
        # Everything downstream of the solve (incl. the (cap, 4, 4, 3)
        # control-point gather + patch derivatives for the normal) stays in
        # the compacted space — running it on all R lanes dominated the
        # whole photon-walk segment at 512^2 (profiled).
        n_c = winner_normal(dir_c, u_c, v_c, pid_c)
        rows = jnp.concatenate([
            t_c[:, None], u_c[:, None], v_c[:, None],
            hit_c.astype(dir.dtype)[:, None], n_c,
        ], axis=1)                                                # (cap, 7)
        base = jnp.tile(
            jnp.asarray([[MAX_DIST, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0]],
                        dir.dtype), (R, 1),
        )
        # compact_indices yields ascending unique indices (trailing
        # out-of-bounds fills are dropped before writing) — telling XLA so
        # lets it emit a parallel scatter without conflict handling.
        out = base.at[idx].set(rows, mode="drop", unique_indices=True,
                               indices_are_sorted=True)           # (R, 7)
        t_best = out[:, 0]
        u_best = out[:, 1]
        v_best = out[:, 2]
        hit = out[:, 3] > 0.5
        n = out[:, 4:7]
    else:
        with jax.named_scope("newton"):
            t_best, u_best, v_best, pid, hit = winner_root(org, dir, ctrl,
                                                           solver)
        n = winner_normal(dir, u_best, v_best, pid)

    hit = hit & obj_gate
    t_best = jnp.where(hit, t_best, MAX_DIST)
    return t_best, hit, u_best, v_best, n


def load_bpt(path: str, scale: float = 1.0, transform: np.ndarray | None = None,
             translate=(0.0, 0.0, 0.0)) -> np.ndarray:
    """Parse a Newell-format ``.bpt`` patch file -> (B, 4, 4, 3) float32.

    Host-side numpy replacement for the reference's stdin-hijacking parser
    (Bezier.h:199-239, quirk #10: ``freopen`` on stdin).  Applies the same
    point pipeline: p -> scale * p -> transform @ p -> p + translate
    (Scene.h:142-154 builds transform = Trans2 @ Trans for the teapot).
    """
    with open(path) as f:
        tok = f.read().split()
    it = iter(tok)
    nxt = lambda: next(it)
    b = int(nxt())
    out = np.empty((b, 4, 4, 3), np.float64)
    tr = np.eye(3) if transform is None else np.asarray(transform, np.float64)
    c = np.asarray(translate, np.float64)
    for p in range(b):
        m, n = int(nxt()), int(nxt())
        assert m == 3 and n == 3, f"patch {p}: only bicubic supported, got {m}x{n}"
        pts = np.array([[float(nxt()) for _ in range(3)] for _ in range(16)])
        pts = (tr @ (pts * scale).T).T + c
        out[p] = pts.reshape(4, 4, 3)
    return out.astype(np.float32)


def teapot_transform() -> np.ndarray:
    """The reference teapot orientation matrix (Scene.h:142-152).

    Trans swaps y/z; Trans2 rotates 90 deg about y; composed Trans2 @ Trans.
    """
    trans = np.zeros((3, 3))
    trans[0, 0] = 1.0
    trans[1, 2] = 1.0
    trans[2, 1] = 1.0
    th = np.pi / 2.0
    trans2 = np.array(
        [
            [np.cos(th), 0.0, np.sin(th)],
            [0.0, 1.0, 0.0],
            [-np.sin(th), 0.0, np.cos(th)],
        ]
    )
    return trans2 @ trans
