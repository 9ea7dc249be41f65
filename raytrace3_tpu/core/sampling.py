"""Random sampling primitives, key-threaded through ``jax.random``.

Batched replacement for the reference's global OpenCV RNG (reference:
``raytracer/Vec3.h:5,15-27``) — which is shared mutable state across OpenMP
threads (a real data race, see SURVEY.md quirk #5).  Here every sampler takes
an explicit PRNG key and is closed-form (no rejection loops), so it vmaps and
shards deterministically: same key => same photons on every topology.

Parity notes:
  * ``uniform_sphere``     <- Vec3::GetUnitRandVec  (Vec3.h:57-65).  The
    reference rejection-samples the unit ball then normalises; the closed-form
    (z, phi) parameterisation below has the identical uniform-on-S2 law.
  * ``cosine_hemisphere``  <- Vec3::GetUnitRandRefl (Vec3.h:90-98): theta =
    acos(sqrt(u1)), phi = 2 pi u2 about the normal — exactly the same density
    (cos(theta)/pi), built here on a branchless orthonormal frame.
  * ``roulette``           <- Obj::Roulette (Obj.h:30-45): categorical draw
    over (diff, refl, refr) mean powers WITHOUT dividing the throughput by the
    branch probability — the reference's (slightly biased) estimator is kept;
    pass ``debias=True`` downstream to divide (Raytracer.h:167-176 keeps the
    de-biased variant commented out).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

TWO_PI = 2.0 * jnp.pi


def uniform_sphere(key: jax.Array, shape=()) -> jnp.ndarray:
    """Uniform directions on the unit sphere, shape ``(*shape, 3)``."""
    ku, kv = jax.random.split(key)
    z = jax.random.uniform(ku, shape, minval=-1.0, maxval=1.0)
    phi = jax.random.uniform(kv, shape, minval=0.0, maxval=TWO_PI)
    r = jnp.sqrt(jnp.maximum(1.0 - z * z, 0.0))
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi), z], axis=-1)


def cosine_hemisphere(key: jax.Array, n: jnp.ndarray) -> jnp.ndarray:
    """Cosine-weighted directions about unit normals ``n`` (..., 3).

    Same law as the reference's double-Rodrigues construction (Vec3.h:90-98):
    p(w) = cos(theta) / pi.
    """
    from .vecmath import orthonormal_frame

    ku, kv = jax.random.split(key)
    batch = n.shape[:-1]
    u1 = jax.random.uniform(ku, batch)
    u2 = jax.random.uniform(kv, batch)
    # sin(theta) = sqrt(1-u1), cos(theta) = sqrt(u1)  (theta = acos(sqrt(u1)))
    ct = jnp.sqrt(u1)
    st = jnp.sqrt(jnp.maximum(1.0 - u1, 0.0))
    phi = TWO_PI * u2
    t, b = orthonormal_frame(n)
    d = (
        t * (st * jnp.cos(phi))[..., None]
        + b * (st * jnp.sin(phi))[..., None]
        + n * ct[..., None]
    )
    return d


def roulette(key: jax.Array, diff_p: jnp.ndarray, refl_p: jnp.ndarray,
             refr_p: jnp.ndarray) -> jnp.ndarray:
    """Russian-roulette branch id per lane: 0=DIFF, 1=REFL, 2=REFR.

    Reference: Obj::Roulette (Obj.h:30-45) — draws r ~ U(0, allr) and picks
    the first bucket whose cumulative power exceeds r.  Degenerate all-zero
    lanes resolve to REFR exactly like the reference's trailing ``else``.
    """
    allr = diff_p + refl_p + refr_p
    r = jax.random.uniform(key, diff_p.shape) * allr
    branch = jnp.where(
        diff_p > r, 0, jnp.where(diff_p + refl_p > r, 1, 2)
    )
    return branch
