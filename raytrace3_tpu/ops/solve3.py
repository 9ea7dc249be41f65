"""Closed-form batched 3x3 linear solve (Cramer / adjugate).

Batched replacement for the reference's ``cv::Matx33d::inv()`` inside the
Newton loop (raytracer/Bezier.h:126-130).  A general inverse is wasted work:
the Newton step only needs ``J^-1 r`` for a J whose columns are three known
3-vectors, so Cramer's rule with cross/dot products is the speed-of-light
formulation — no pivoting, no divergence, pure elementwise arithmetic.
"""

from __future__ import annotations

import jax.numpy as jnp


def _cross(a, b):
    return jnp.stack(
        [
            a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
        ],
        axis=-1,
    )


def _dot(a, b):
    return jnp.sum(a * b, axis=-1)


def solve3_columns(c0, c1, c2, r, det_eps: float = 1e-12):
    """Solve ``[c0 | c1 | c2] x = r`` for batched 3-vectors.

    Returns (x0, x1, x2, ok) where ok flags |det| > det_eps; x is zero on
    singular lanes (callers mask them out, matching the reference's behaviour
    of letting a garbage inverse fail the residual test).
    """
    c12 = _cross(c1, c2)
    det = _dot(c0, c12)
    ok = jnp.abs(det) > det_eps
    inv_det = jnp.where(ok, 1.0 / jnp.where(ok, det, 1.0), 0.0)
    x0 = _dot(r, c12) * inv_det
    x1 = _dot(c0, _cross(r, c2)) * inv_det
    x2 = _dot(c0, _cross(c1, r)) * inv_det
    return x0, x1, x2, ok
