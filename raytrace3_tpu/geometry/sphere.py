"""Ray-sphere intersection and spherical-polar UV, fully vectorised.

Reference: ``SphereObj`` (raytracer/Obj.h:102-154).  Differentiable w.r.t.
center and radius (plain quadratic-root algebra, no data-dependent control
flow).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.pytree import pytree_dataclass
from ..core.vecmath import M_EPS, MAX_DIST, dot, normalize
from ..ops.onehot import take_rows


@pytree_dataclass
class Spheres:
    center: jnp.ndarray  # (S, 3)
    radius: jnp.ndarray  # (S,)
    # Pole axes of the reference's spherical UV map (Obj.h:107):
    # texU = (0,3,-3)/|.|, texV = (1,0,0) — shared by all spheres.
    tex_u: jnp.ndarray   # (3,)
    tex_v: jnp.ndarray   # (3,)

    @property
    def count(self) -> int:
        return self.center.shape[0]


def make_spheres(center, radius) -> Spheres:
    return Spheres(
        center=jnp.asarray(center, jnp.float32).reshape(-1, 3),
        radius=jnp.asarray(radius, jnp.float32).reshape(-1),
        tex_u=normalize(jnp.array([0.0, 3.0, -3.0], jnp.float32)),
        tex_v=jnp.array([1.0, 0.0, 0.0], jnp.float32),
    )


def intersect_spheres(org: jnp.ndarray, dir: jnp.ndarray, spheres: Spheres):
    """All-pairs ray-sphere hits.

    Reference: SphereObj::GetIntersect (Obj.h:111-139).  Root pick: near root
    ``proj - det`` when > M_EPS, else far root; miss when det2 < M_EPS or the
    far root < M_EPS.  ``inside`` = near root rejected (origin inside).

    Args:
      org, dir: (R, 3) with unit dir.
    Returns:
      t: (R, S), hit: (R, S) bool, inside: (R, S) bool.
    """
    L = spheres.center[None, :, :] - org[:, None, :]          # (R, S, 3)
    proj = jnp.einsum("rsc,rc->rs", L, dir,
                      precision=jax.lax.Precision.HIGHEST)                    # (R, S)
    det2 = spheres.radius[None, :] ** 2 - (jnp.sum(L * L, -1) - proj * proj)
    # sqrt argument guarded by the miss condition itself: sqrt(max(x, 0))
    # has a NaN reverse-mode derivative on every missing lane (x < 0), which
    # matters once org/dir carry gradients (secondary rays).
    miss = det2 < M_EPS
    det = jnp.sqrt(jnp.where(miss, 1.0, det2))
    d1 = proj - det
    d2 = proj + det
    inside = d1 < M_EPS
    t = jnp.where(inside, d2, d1)
    hit = ~miss & (d2 >= M_EPS)
    return jnp.where(hit, t, MAX_DIST), hit, inside


def sphere_uv(pos: jnp.ndarray, spheres: Spheres, sphere_idx: jnp.ndarray):
    """Spherical UV at hit position (reference: Obj.h:140-153).

    theta = acos(N . texV); phi = acos(clip(N . texU / sin(theta)));
    u = theta/pi, v = phi/(2 pi), mirrored when N . (texU x texV) < 0.
    """
    n = normalize(pos - take_rows(spheres.center, sphere_idx))
    # Clip strictly inside [-1, 1]: arccos' diverges at the endpoints and a
    # hard clip there yields 0 * inf = NaN in reverse-mode AD (this function
    # runs for every ray, masked after the fact).
    lim = 1.0 - 1e-6
    ct = jnp.clip(dot(n, spheres.tex_v), -lim, lim)
    theta = jnp.arccos(ct)
    st = jnp.sin(theta)
    t = dot(n, spheres.tex_u) / jnp.where(st < 1e-12, 1e-12, st)
    phi = jnp.arccos(jnp.clip(t, -lim, lim))
    u = theta / jnp.pi
    v = phi / (2.0 * jnp.pi)
    flip = dot(n, jnp.cross(spheres.tex_u, spheres.tex_v)) < 0.0
    v = jnp.where(flip, 1.0 - v, v)
    return u, v
