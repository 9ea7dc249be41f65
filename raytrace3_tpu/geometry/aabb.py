"""Axis-aligned bounding boxes: batched branchless slab test.

Reference: ``AABBbox`` (raytracer/Bezier.h:7-57) implements an approximate
boolean entry test (per-axis candidate-t + in-box check of the other two
coordinates).  The standard slab test below is exact, cheaper, and branchless
— SURVEY.md C8 nominates it as the batched replacement.
"""

from __future__ import annotations

import jax.numpy as jnp


def aabb_from_points(points: jnp.ndarray):
    """(..., K, 3) points -> (pmin, pmax) each (..., 3).

    Reference: AABBbox::addpoint loop (Bezier.h:12-19)."""
    return jnp.min(points, axis=-2), jnp.max(points, axis=-2)


def slab_test(org: jnp.ndarray, dir: jnp.ndarray, pmin: jnp.ndarray,
              pmax: jnp.ndarray, t_eps: float = 0.0):
    """Branchless ray-box test.

    Zero direction components produce +/-inf slabs which resolve correctly
    under min/max (IEEE semantics preserved by XLA).

    Args:
      org, dir: (..., 3); pmin, pmax broadcastable to (..., 3).
    Returns:
      hit: (...,) bool — the box is intersected at some t >= t_eps.
    """
    inv = 1.0 / dir  # +/-inf where dir == 0 is intentional
    t0 = (pmin - org) * inv
    t1 = (pmax - org) * inv
    tnear = jnp.max(jnp.minimum(t0, t1), axis=-1)
    tfar = jnp.min(jnp.maximum(t0, t1), axis=-1)
    # NaNs (0 * inf when org sits exactly on a slab) must not propagate:
    tnear = jnp.where(jnp.isnan(tnear), -jnp.inf, tnear)
    tfar = jnp.where(jnp.isnan(tfar), jnp.inf, tfar)
    return tfar >= jnp.maximum(tnear, t_eps)
