"""Scene pytree + fused nearest-hit ("NearCollide") over all primitives.

Reference: ``Scene`` (raytracer/Scene.h:93-183).  The reference's virtual
``Obj::GetIntersect`` scan (Scene.h:165-182) becomes one batched program:
vmapped plane/sphere tests, the batched Bezier Newton solve, then a single
argmin over the primitive axis — no virtual dispatch, no branches.

Object-id layout (matches the reference objvec order for the full scene,
Scene.h:116-156): planes [0, P), spheres [P, P+S), bezier object P+S.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..core.pytree import pytree_dataclass, static_field
from ..core.types import HitRecord, Materials
from ..core.vecmath import MAX_DIST, normalize
from ..ops.onehot import pick_columns, take_rows
from ..textures.texture import sample_atlas
from .bezier import BezierObject, intersect_bezier
from .plane import Planes, intersect_planes, plane_uv
from .sphere import Spheres, intersect_spheres, sphere_uv


@pytree_dataclass
class Scene:
    planes: Planes
    spheres: Spheres
    bezier: BezierObject | None      # None when the scene has no patches
    materials: Materials             # (N,) object-major tables
    obj_color: jnp.ndarray           # (N, 3) flat colour (Obj.h:46)
    obj_tex: jnp.ndarray             # (N,) int32 atlas id, -1 = flat colour
    atlas: jnp.ndarray               # (T, H, W, 3)
    light_pos: jnp.ndarray           # (L, 3)
    light_color: jnp.ndarray         # (L, 3)
    # Static (non-pytree) fields:
    #: Reference quirk #1 (Bezier.h:278): the teapot texture lookup passes
    #: (u=surface u, v=ray distance t) instead of (u, v).  On by default for
    #: parity; set False for the sane mapping.
    bezier_uv_quirk: bool = static_field(default=True)
    #: Fraction of rays gathered through the object-AABB compaction before
    #: the Newton solve (1.0 = dense, no compaction).
    bezier_compact_frac: float = static_field(default=1.0)
    #: Newton budget (reference: 10 iters x 50 random restarts, Bezier.h:6,115;
    #: we default 10 iters x 4x4 stratified restarts).
    newton_iters: int = static_field(default=10)
    newton_restarts: int = static_field(default=4)

    @property
    def n_planes(self) -> int:
        return self.planes.count

    @property
    def n_spheres(self) -> int:
        return self.spheres.count

    @property
    def has_bezier(self) -> bool:
        return self.bezier is not None

    @property
    def n_objects(self) -> int:
        return self.n_planes + self.n_spheres + (1 if self.has_bezier else 0)


def intersect_scene(scene: Scene, org: jnp.ndarray, dir: jnp.ndarray,
                    newton_fn=None) -> HitRecord:
    """Nearest hit for a batch of rays (R, 3) -> HitRecord.

    Reference: Scene::NearCollide (Scene.h:165-182) — linear min-dist scan —
    plus the per-object colour/normal resolution each GetIntersect performs.
    Here colour and normal are resolved once, for the argmin winner only.
    """
    R = org.shape[0]
    P, S = scene.n_planes, scene.n_spheres

    tp, _ = intersect_planes(org, dir, scene.planes)          # (R, P)
    ts, _, ins_s = intersect_spheres(org, dir, scene.spheres)  # (R, S)

    parts = [tp, ts]
    if scene.has_bezier:
        tb, hb, ub, vb, nb = intersect_bezier(
            org, dir, scene.bezier,
            iters=scene.newton_iters, restarts=scene.newton_restarts,
            newton_fn=newton_fn, compact_frac=scene.bezier_compact_frac,
        )
        parts.append(jnp.where(hb, tb, MAX_DIST)[:, None])
    t_all = jnp.concatenate(parts, axis=1)                     # (R, N)

    obj = jnp.argmin(t_all, axis=1).astype(jnp.int32)          # (R,)
    t = jnp.min(t_all, axis=1)          # == t_all[row, argmin] lane-free
    hit = t < MAX_DIST
    obj_id = jnp.where(hit, obj, -1)
    # Clamp the sentinel distance before forming positions: miss lanes are
    # fully masked downstream, but unclamped 1e9-scale positions would feed
    # NaN partial derivatives back through squared-distance terms.
    pos = org + jnp.minimum(t, 1e6)[:, None] * dir

    is_plane = obj < P
    is_sphere = (obj >= P) & (obj < P + S)
    pi = jnp.clip(obj, 0, P - 1)
    si = jnp.clip(obj - P, 0, S - 1)

    # Normal: planes keep the stored (unflipped) normal (Obj.h:80), spheres
    # the outward normal (Obj.h:133), bezier the viewer-facing patch normal.
    # Small-table lookups use one-hot contractions (ops/onehot.py): XLA's
    # gather costs per index and dominated the walk segment when profiled.
    n = take_rows(scene.planes.normal, pi)
    n = jnp.where(is_sphere[:, None],
                  normalize(pos - take_rows(scene.spheres.center, si)), n)
    if scene.has_bezier:
        n = jnp.where((~is_plane & ~is_sphere)[:, None], nb, n)

    inside = is_sphere & pick_columns(ins_s, si)               # (Obj.h:136)

    # Colour: texture UV per primitive family, else flat object colour.
    up, vp = plane_uv(pos, scene.planes, pi)
    us, vs = sphere_uv(pos, scene.spheres, si)
    u = jnp.where(is_sphere, us, up)
    v = jnp.where(is_sphere, vs, vp)
    if scene.has_bezier:
        bmask = ~is_plane & ~is_sphere
        u = jnp.where(bmask, ub, u)
        v = jnp.where(bmask, t if scene.bezier_uv_quirk else vb, v)

    obj_c = jnp.clip(obj, 0, scene.n_objects - 1)
    tex_id = take_rows(scene.obj_tex, obj_c)
    tex_col = sample_atlas(scene.atlas, tex_id, u, v)
    flat_col = take_rows(scene.obj_color, obj_c)
    color = jnp.where((tex_id >= 0)[:, None], tex_col, flat_col)

    return HitRecord(t=t, hit=hit, pos=pos, n=n, inside=inside,
                     obj_id=obj_id, color=color)
