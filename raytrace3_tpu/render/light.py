"""Photon sources: batched isotropic point-light emission.

Reference: ``Light::emit`` (raytracer/Light.h:8-13): one photon at a time,
origin = light position, direction uniform on the sphere, flux = colour * 4pi.
(``SpotLight`` adds nothing — it only shadows private fields, Light.h:19-26.)

Batched: one key -> a whole ``(N, 3)`` batch of photon origins/dirs/fluxes,
round-robin across the scene's lights exactly like the reference's
per-light inner loop (Raytracer.h:226-233).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.sampling import uniform_sphere


def emit_photons(key: jax.Array, light_pos: jnp.ndarray,
                 light_color: jnp.ndarray, n_photons: int):
    """Sample ``n_photons`` photons per light (stacked).

    Args:
      light_pos: (L, 3); light_color: (L, 3).
    Returns:
      org, dir, flux: each (L * n_photons, 3).
    """
    L = light_pos.shape[0]
    dirs = uniform_sphere(key, (L, n_photons))                # (L, N, 3)
    org = jnp.broadcast_to(light_pos[:, None, :], dirs.shape)
    flux = jnp.broadcast_to(
        (light_color * (4.0 * jnp.pi))[:, None, :], dirs.shape
    )
    n = L * n_photons
    return org.reshape(n, 3), dirs.reshape(n, 3), flux.reshape(n, 3)
