"""Core batched data types (SoA pytrees) for the renderer.

The reference keeps scalar C++ objects (``Ray``/``Material``/``Collision`` at
``raytracer/Element.h:6-41``, ``HitPoint`` at ``raytracer/Raytracer.h:47-80``)
and heap-allocated vectors of pointers.  Here every record becomes a
struct-of-arrays pytree with a static capacity and a validity mask, so the
whole render traces to fixed shapes that XLA compiles into fused batched
kernels.
"""

from __future__ import annotations

import jax.numpy as jnp

from .pytree import pytree_dataclass
from .vecmath import any_near_zero, mean_power


@pytree_dataclass
class Materials:
    """Per-object material table (object id -> coefficients).

    Reference: ``Material`` (Element.h:7-19) — diffuse / specular-reflect /
    refract RGB coefficients plus refractive index ``refrn``.  ``refln`` is
    carried by the reference but never used on the hot path (Element.h:15);
    we keep it for API parity.
    """

    diff: jnp.ndarray   # (N, 3)
    refl: jnp.ndarray   # (N, 3)
    refr: jnp.ndarray   # (N, 3)
    refrn: jnp.ndarray  # (N,)
    refln: jnp.ndarray  # (N,)

    # Lobe predicates — reference quirk preserved: a lobe is active only when
    # NO channel is within 1e-4 of zero (Element.h:16-18 + Vec3.h:72-79).
    def is_diff(self) -> jnp.ndarray:
        return ~any_near_zero(self.diff)

    def is_refl(self) -> jnp.ndarray:
        return ~any_near_zero(self.refl)

    def is_refr(self) -> jnp.ndarray:
        return ~any_near_zero(self.refr)

    # Roulette scalar powers (Obj.h:11-16): mean of each lobe's channels.
    def powers(self):
        return mean_power(self.diff), mean_power(self.refl), mean_power(self.refr)

    def eta(self, obj_idx: jnp.ndarray, inside: jnp.ndarray) -> jnp.ndarray:
        """Relative index n_from/n_to for the refraction at a hit
        (Raytracer.h:187,332: 1/refrn entering, refrn exiting).

        Guarded against refrn == 0: several reference materials pass rr=0
        (Scene.h:100-108) — their refraction lobe is inactive so the value is
        never used, but an unguarded 1/0 = inf poisons reverse-mode AD on
        the masked branch.
        """
        return eta_from_refrn(self.refrn[obj_idx], inside)


def eta_from_refrn(rn: jnp.ndarray, inside: jnp.ndarray) -> jnp.ndarray:
    """Relative refraction index from per-lane refrn values (see
    ``Materials.eta``); split out so callers that already fetched refrn
    through a combined material-table lookup can reuse the guarded math."""
    safe = jnp.where(jnp.abs(rn) < 1e-6, 1.0, rn)
    return jnp.where(inside, safe, 1.0 / safe)


@pytree_dataclass
class HitRecord:
    """Resolved nearest-hit data for a batch of rays.

    Reference: ``Collision`` (Element.h:20-38).  ``hit`` replaces the
    ``obj != nullptr`` validity test; ``color`` is the texture/albedo colour
    at the hit (reference resolves it inside each ``GetIntersect``).
    """

    t: jnp.ndarray        # (R,)   distance, MAX_DIST when miss
    hit: jnp.ndarray      # (R,)   bool
    pos: jnp.ndarray      # (R, 3)
    n: jnp.ndarray        # (R, 3) normal AS THE REFERENCE STORES IT (planes:
    #        constant plane normal, spheres: outward, bezier: viewer-facing)
    inside: jnp.ndarray   # (R,)   bool — sphere entry/exit flag (Obj.h:136)
    obj_id: jnp.ndarray   # (R,)   int32, -1 on miss
    color: jnp.ndarray    # (R, 3) surface colour at hit


@pytree_dataclass
class HitPoints:
    """SPPM camera-side measurement points, fixed capacity ``C``.

    Reference: ``HitPoint`` (Raytracer.h:47-80) stored in an unbounded
    ``vector<HitPoint*>`` (Raytracer.h:101).  Fixed capacity + ``valid`` mask
    makes the photon pass a static-shape program.
    """

    pos: jnp.ndarray    # (C, 3)
    n: jnp.ndarray      # (C, 3)
    wgt: jnp.ndarray    # (C, 3) pixel weight (texcolor * path wgt * diff)
    pixel: jnp.ndarray  # (C,) int32 flattened pixel id y*W + x
    valid: jnp.ndarray  # (C,) bool
    r2: jnp.ndarray     # (C,) gather radius^2 (init INIT_R2=2.0, Raytracer.h:13)
    nphot: jnp.ndarray  # (C,) float accumulated photon count N
    tao: jnp.ndarray    # (C, 3) accumulated reflected flux

    @property
    def capacity(self) -> int:
        return self.pos.shape[0]


def make_hitpoints(capacity: int, init_r2: float, dtype=jnp.float32) -> HitPoints:
    return HitPoints(
        pos=jnp.zeros((capacity, 3), dtype),
        n=jnp.zeros((capacity, 3), dtype),
        wgt=jnp.zeros((capacity, 3), dtype),
        pixel=jnp.zeros((capacity,), jnp.int32),
        valid=jnp.zeros((capacity,), bool),
        r2=jnp.full((capacity,), init_r2, dtype),
        nphot=jnp.zeros((capacity,), dtype),
        tao=jnp.zeros((capacity, 3), dtype),
    )


@pytree_dataclass
class Deposits:
    """Photon deposit events of one photon round, fixed capacity ``D``.

    One record per diffuse photon-surface interaction — the reference performs
    the kd-tree radius query inline at each such event (Raytracer.h:137-159);
    we batch the events and run one gather/matmul kernel per round instead.
    ``flux`` is the photon flux ON ARRIVAL (before the albedo multiply), as
    deposited by Raytracer.h:156.
    """

    pos: jnp.ndarray    # (D, 3)
    n: jnp.ndarray      # (D, 3) surface normal at the deposit
    flux: jnp.ndarray   # (D, 3)
    valid: jnp.ndarray  # (D,) bool
