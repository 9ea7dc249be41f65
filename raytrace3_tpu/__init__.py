"""raytrace3_tpu — differentiable SPPM renderer in JAX.

A from-scratch JAX/Pallas re-design of the capabilities of
wondergo2017/raytrace3 (a C++/OpenMP stochastic progressive photon mapping
ray tracer): SPPM rendering of planes, spheres and cubic-Bezier patches with
textures, caustics, anti-aliased progressive passes — rebuilt as a
functional, jittable, differentiable, multi-chip program.
"""

__version__ = "0.1.0"

from .core import sampling, types, vecmath  # noqa: F401
from .geometry.scene import Scene, intersect_scene  # noqa: F401
from .render.camera import Camera, emit_rays, look_at  # noqa: F401
from .render.sppm import render_pass, tonemap  # noqa: F401
from .scenes import get_scene  # noqa: F401
