"""Vector math core: pure, vmappable functions on (..., 3) arrays.

Batched re-design of the reference's ``Vec3`` class (reference:
``raytracer/Vec3.h:28-155``).  Instead of a scalar 3-vector class we operate on
batched ``(..., 3)`` jnp arrays so every op vectorises and fuses under jit.  All functions are branchless (``jnp.where`` selects) so they trace
once under XLA.

Parity notes (reference file:line):
  * ``reflect``    <- Vec3::GetRefl        (Vec3.h:80-84)
  * ``refract``    <- Vec3::refracted      (Vec3.h:120-134) incl. the
    total-internal-reflection fallback to the mirror reflection.
  * ``anormal``    <- Vec3::GetAnormal     (Vec3.h:85-89)
  * ``rotate``     <- Vec3::rotated        (Vec3.h:99-115) (Rodrigues form)
  * ``normalize``  <- Vec3::Normalize      (Vec3.h:48-55) (guards |v|~0)
  * ``any_near_zero`` <- IsZero(Vec3)      (Vec3.h:72-79): true when ANY
    component is within M_EPS of zero — this quirky predicate drives the
    material-lobe gates (Element.h:16-18) and is preserved on purpose.
"""

from __future__ import annotations

import jax.numpy as jnp

#: Reference epsilon (reference: raytracer/Vec3.h:6 ``#define M_EPS 1e-4``).
M_EPS = 1e-4

#: Large sentinel distance (reference: Vec3.h:11 ``MAX_NUM 1e20``).  Chosen
#: so that squares and squared distances of sentinel-scaled positions stay
#: finite in float32 (1e9^2 = 1e18 << 3.4e38): overflow on masked miss lanes
#: would otherwise poison reverse-mode AD with inf * 0 = NaN partials.
MAX_DIST = 1e9


def dot(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Batched dot product over the trailing axis -> (...)."""
    return jnp.sum(a * b, axis=-1)


def cross(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return jnp.cross(a, b)


def norm2(v: jnp.ndarray) -> jnp.ndarray:
    """Squared module (reference: Vec3.h:44 ``Module2``)."""
    return jnp.sum(v * v, axis=-1)


def norm(v: jnp.ndarray) -> jnp.ndarray:
    return jnp.sqrt(norm2(v))


def normalize(v: jnp.ndarray) -> jnp.ndarray:
    """Unit vector; leaves near-zero vectors untouched.

    Mirrors Vec3::Normalize (Vec3.h:48-55) which is a no-op when |v| < M_EPS
    — important because degenerate directions flow through masked-out lanes.
    The sqrt is taken on a guarded value so reverse-mode AD never sees
    sqrt'(0) = inf on the masked branch (the classic where-grad trap).
    """
    n2 = norm2(v)[..., None]
    small = n2 < M_EPS * M_EPS
    m = jnp.sqrt(jnp.where(small, 1.0, n2))
    return jnp.where(small, v, v / m)


def dist2(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    d = a - b
    return jnp.sum(d * d, axis=-1)


def reflect(d: jnp.ndarray, n: jnp.ndarray) -> jnp.ndarray:
    """Mirror reflection of direction ``d`` about normal ``n``.

    Reference: Vec3::GetRefl (Vec3.h:80-84): ``d - 2 (d.n) n``.
    """
    return d - 2.0 * dot(d, n)[..., None] * n


def refract(d: jnp.ndarray, n: jnp.ndarray, eta: jnp.ndarray) -> jnp.ndarray:
    """Snell refraction with total-internal-reflection fallback.

    Reference: Vec3::refracted (Vec3.h:124-134).  ``eta = n_from / n_to``;
    ``n`` must point against ``d`` (the caller flips it when exiting, matching
    Raytracer.h:188,333).  When ``cosR2 <= M_EPS`` (TIR) the reference returns
    the mirror reflection — we select it branchlessly.
    """
    eta = jnp.broadcast_to(jnp.asarray(eta, d.dtype), d.shape[:-1])
    cos_i = -dot(n, d)
    cos_r2 = 1.0 - (1.0 - cos_i * cos_i) * eta * eta
    ok = cos_r2 > M_EPS
    # sqrt argument guarded on the TIR branch so its grad stays finite there.
    cos_r = jnp.sqrt(jnp.where(ok, cos_r2, 1.0))
    refr = d * eta[..., None] + n * (eta * cos_i - cos_r)[..., None]
    tir = reflect(d, n)
    return jnp.where(ok[..., None], refr, tir)


def anormal(v: jnp.ndarray) -> jnp.ndarray:
    """A unit vector orthogonal to ``v`` (tangent-frame seed).

    Reference: Vec3::GetAnormal (Vec3.h:85-89): returns (1,0,0) when the xy
    part vanishes, else normalize((v.y, -v.x, 0)).
    """
    xy0 = (v[..., 0] == 0.0) & (v[..., 1] == 0.0)
    t = jnp.stack([v[..., 1], -v[..., 0], jnp.zeros_like(v[..., 0])], axis=-1)
    t = normalize(t)
    ex = jnp.zeros_like(v).at[..., 0].set(1.0)
    return jnp.where(xy0[..., None], ex, t)


def rotate(v: jnp.ndarray, axis: jnp.ndarray, angle: jnp.ndarray) -> jnp.ndarray:
    """Rodrigues rotation of ``v`` about unit ``axis`` by ``angle``.

    Reference: Vec3::rotated (Vec3.h:99-115).  The reference special-cases
    |angle| < M_EPS as identity; we keep that select for parity (the rotation
    matrix form is exact there anyway, but the select keeps NaN-free grads
    for masked lanes).
    """
    angle = jnp.asarray(angle)
    c = jnp.cos(angle)[..., None]
    s = jnp.sin(angle)[..., None]
    ax_dot_v = dot(axis, v)[..., None]
    rot = v * c + cross(axis, v) * s + axis * ax_dot_v * (1.0 - c)
    return jnp.where(jnp.abs(angle)[..., None] < M_EPS, v, rot)


def any_near_zero(v: jnp.ndarray) -> jnp.ndarray:
    """True when ANY component is within M_EPS of zero.

    Reference quirk preserved verbatim: ``IsZero(const Vec3&)`` (Vec3.h:72-79)
    returns true if any |component| < 1e-4, and Material::Is{Diff,Refl,Refr}
    (Element.h:16-18) negate it — so a lobe is "on" only when every RGB
    channel is bounded away from zero.
    """
    return jnp.any(jnp.abs(v) < M_EPS, axis=-1)


def mean_power(v: jnp.ndarray) -> jnp.ndarray:
    """Scalar lobe power = mean of components (reference: Vec3.h:116-119
    ``GetPower``; used for roulette weights at Obj.h:11-16)."""
    return jnp.mean(v, axis=-1)


def orthonormal_frame(n: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Build (t, b) with (t, b, n) orthonormal, branchless (Duff et al.).

    Used by the closed-form cosine-hemisphere sampler; the reference instead
    composes two Rodrigues rotations (Vec3.h:90-98) which we keep available in
    :func:`rotate` for parity tests.
    """
    s = jnp.where(n[..., 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    t1 = jnp.stack(
        [1.0 + s * n[..., 0] ** 2 * a, s * b, -s * n[..., 0]], axis=-1
    )
    t2 = jnp.stack([b, s + n[..., 1] ** 2 * a, -n[..., 1]], axis=-1)
    return t1, t2
