"""Ray-plane intersection and planar UV mapping, fully vectorised.

Reference: ``PlaneObj`` (raytracer/Obj.h:55-101).  We compute all (R rays x
P planes) candidate hits branchlessly; the scene layer argmins over
primitives.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.pytree import pytree_dataclass
from ..core.vecmath import M_EPS, MAX_DIST, dot, normalize
from ..ops.onehot import pick_columns, take_rows


@pytree_dataclass
class Planes:
    p0: jnp.ndarray       # (P, 3) a point on each plane (Obj.h:58)
    normal: jnp.ndarray   # (P, 3) unit normal, NOT flipped toward rays (Obj.h:59)
    # Planar texture scale vectors (Obj.h:63-64): texU=(400,0,0), texV=(0,0,300).
    # Only their moduli enter the UV map, so we store the scalars.
    tex_u_mod: jnp.ndarray  # (P,) |texU| = 400
    tex_v_mod: jnp.ndarray  # (P,) |texV| = 300

    @property
    def count(self) -> int:
        return self.p0.shape[0]


def make_planes(p0, normal, tex_u_mod=400.0, tex_v_mod=300.0) -> Planes:
    p0 = jnp.asarray(p0, jnp.float32).reshape(-1, 3)
    n = normalize(jnp.asarray(normal, jnp.float32).reshape(-1, 3))
    count = p0.shape[0]
    return Planes(
        p0=p0,
        normal=n,
        tex_u_mod=jnp.broadcast_to(jnp.asarray(tex_u_mod, jnp.float32), (count,)),
        tex_v_mod=jnp.broadcast_to(jnp.asarray(tex_v_mod, jnp.float32), (count,)),
    )


def intersect_planes(org: jnp.ndarray, dir: jnp.ndarray, planes: Planes):
    """All-pairs ray-plane hits.

    Reference: PlaneObj::GetIntersect (Obj.h:65-85): miss when the direction
    is within M_EPS of parallel or when the signed distance <= M_EPS.

    Args:
      org, dir: (R, 3)
    Returns:
      t: (R, P) hit distance (MAX_DIST on miss), hit: (R, P) bool.
    """
    proj = jnp.einsum("rc,pc->rp", dir, planes.normal,
                      precision=jax.lax.Precision.HIGHEST)
    num = jnp.einsum("rpc,pc->rp",
                     planes.p0[None, :, :] - org[:, None, :], planes.normal,
                     precision=jax.lax.Precision.HIGHEST)
    safe = jnp.where(jnp.abs(proj) < M_EPS, 1.0, proj)
    t = num / safe
    hit = (jnp.abs(proj) >= M_EPS) & (t > M_EPS)
    return jnp.where(hit, t, MAX_DIST), hit


def plane_axis_indices(normal: jnp.ndarray):
    """The reference's axis-aligned UV axis pick (Obj.h:89-96).

    ``ndir`` = LAST axis with a nonzero normal component; udex=(ndir+1)%3,
    vdex=(ndir+2)%3.  Returns (udex, vdex) as int32 arrays, shape (P,).
    """
    nz = normal != 0.0
    ndir = jnp.where(nz[..., 2], 2, jnp.where(nz[..., 1], 1, 0))
    return (ndir + 1) % 3, (ndir + 2) % 3


def plane_uv(pos: jnp.ndarray, planes: Planes, plane_idx: jnp.ndarray):
    """Planar UV at hit position for the plane ``plane_idx`` of each ray.

    Reference quirk preserved (Obj.h:97-98): u is scaled by |texV| and v by
    |texU| — the scales are SWAPPED relative to their names.

    Args:
      pos: (R, 3) hit positions; plane_idx: (R,) int32 (clipped by caller).
    Returns:
      (u, v): each (R,)
    """
    # Small-table lookups + per-row axis picks via one-hot contractions
    # (ops/onehot.py) — XLA gathers cost per index and these run for every
    # walk segment.
    p0 = take_rows(planes.p0, plane_idx)
    n = take_rows(planes.normal, plane_idx)
    udex, vdex = plane_axis_indices(n)
    d = pos - p0
    v = 0.5 + pick_columns(d, vdex) / take_rows(planes.tex_u_mod, plane_idx)
    u = 0.5 + pick_columns(d, udex) / take_rows(planes.tex_v_mod, plane_idx)
    return u, v
