"""Pinhole camera: basis construction + vmapped pixel-grid ray generation.

Reference: ``Camera`` (raytracer/Camera.h:4-114).  The reference couples the
camera with a heap-allocated canvas (Camera.h:13,46-53); here the canvas is a
separate ``(H, W, 3)`` accumulator owned by the render driver and the camera
is a small immutable pytree, cheap to jitter per SPPM pass.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..core.pytree import pytree_dataclass, static_field
from ..core.vecmath import cross, normalize

#: Reference field of view (Camera.h:44): 50 degrees.
DEFAULT_FOV_DEG = 50.0
#: Reference canvas (Camera.h:16-17).
DEFAULT_RES = 1024


@pytree_dataclass
class Camera:
    pos: jnp.ndarray   # (3,)
    dir: jnp.ndarray   # (3,) forward, SCALED by 0.5/tan(fov/2) (Camera.h:45)
    du: jnp.ndarray    # (3,) unit right
    dv: jnp.ndarray    # (3,) unit up-ish
    width: int = static_field(default=DEFAULT_RES)
    height: int = static_field(default=DEFAULT_RES)


def look_at(pos, look, width: int = DEFAULT_RES, height: int = DEFAULT_RES,
            fov_deg: float = DEFAULT_FOV_DEG) -> Camera:
    """Build the reference basis (Camera.h:32-54): up = (0,0,1),
    du = normalize(dir x up), dv = normalize(-dir x du), dir *= 0.5/tan(fov/2).
    """
    pos = jnp.asarray(pos, jnp.float32)
    look = jnp.asarray(look, jnp.float32)
    up = jnp.array([0.0, 0.0, 1.0], jnp.float32)
    d = normalize(look - pos)
    du = normalize(cross(d, up))
    dv = normalize(-cross(d, du))
    fov = jnp.deg2rad(fov_deg)
    d = d * (0.5 / jnp.tan(fov / 2.0))
    return Camera(pos=pos, dir=d, du=du, dv=dv, width=width, height=height)


def emit_rays(cam: Camera):
    """Primary rays for every pixel, row-major (y * W + x) order.

    Reference: Camera::emit (Camera.h:18-22):
    d = du ((x+.5)/w - .5) + dv ((y+.5)/h - .5) + dir, normalised.

    Returns (org, dir): each (H*W, 3); org is the camera position broadcast.
    """
    h, w = cam.height, cam.width
    x = (jnp.arange(w, dtype=jnp.float32) + 0.5) / w - 0.5
    y = (jnp.arange(h, dtype=jnp.float32) + 0.5) / h - 0.5
    d = (
        cam.du[None, None, :] * x[None, :, None]
        + cam.dv[None, None, :] * y[:, None, None]
        + cam.dir[None, None, :]
    )
    d = normalize(d).reshape(h * w, 3)
    org = jnp.broadcast_to(cam.pos, (h * w, 3))
    return org, d
