"""Texture atlas: fixed-shape device array + bilinear wraparound sampling.

Reference: ``Texture`` (raytracer/Element.h:43-75) loads one cv::Mat per
texture and bilinearly samples it per hit, CPU-side.  Here all textures are
resampled to one common resolution and stacked into a single
``(T, H, W, 3)`` atlas that lives in device memory as part of the scene
pytree — so the per-ray sample is one batched gather, and the atlas itself
is a learnable parameter (BASELINE.json: gradients w.r.t. texture maps).

Procedural generators below stand in for the reference's asset JPEGs
(wall/timg/planet/blue — ``blue.jpg`` is even missing from the reference
repo, Scene.h:155 / SURVEY quirk #11) so the test-suite needs no image files;
``load_image`` pulls real assets when present.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp


def sample_bilinear_wrap(tex: jnp.ndarray, u: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """Bilinear sample with the reference's exact wrap rule.

    Reference: Texture::colorUV (Element.h:61-72): row = fract(u) * rows,
    col = fract(v) * cols; r1 = floor(row + 1e-10), r2 = r1 + 1; weights
    detR = r2 - row, detC = c2 - col; out-of-range r1 wraps to rows-1 / 0 and
    r2 wraps to 0.

    Args:
      tex: (H, W, 3) or (..., H, W, 3) single texture; u, v: (...,).
    Returns:
      (..., 3)
    """
    rows, cols = tex.shape[-3], tex.shape[-2]
    row = (u - jnp.floor(u)) * rows
    col = (v - jnp.floor(v)) * cols
    r1 = jnp.floor(row + 1e-10).astype(jnp.int32)
    c1 = jnp.floor(col + 1e-10).astype(jnp.int32)
    r2, c2 = r1 + 1, c1 + 1
    det_r = (r2 - row)[..., None]
    det_c = (c2 - col)[..., None]
    r1 = jnp.where(r1 >= 0, jnp.where(r1 >= rows, 0, r1), rows - 1)
    c1 = jnp.where(c1 >= 0, jnp.where(c1 >= cols, 0, c1), cols - 1)
    r2 = jnp.where(r2 < rows, r2, 0)
    c2 = jnp.where(c2 < cols, c2, 0)
    g = lambda r, c: tex[r, c, :]
    return (
        g(r1, c1) * det_r * det_c
        + g(r1, c2) * det_r * (1.0 - det_c)
        + g(r2, c1) * (1.0 - det_r) * det_c
        + g(r2, c2) * (1.0 - det_r) * (1.0 - det_c)
    )


def pack_atlas_2x2(atlas: jnp.ndarray) -> jnp.ndarray:
    """(T, H, W, 3) -> (T, H, W, 12): each texel + its 3 bilinear neighbours.

    Texel (r, c) of the packed atlas holds [T(r,c), T(r,c+1), T(r+1,c),
    T(r+1,c+1)] with the reference wrap rule (r/c + 1 wrapping to 0,
    Element.h:66-69) — exactly ``jnp.roll`` by -1.  Lets bilinear sampling
    fetch all four taps with ONE gather instead of four (gathers cost per
    index, not per byte).  Differentiable w.r.t. the atlas; tiny
    (atlas-sized) so it amortises to nothing when hoisted out of the photon
    scan by XLA (the atlas is loop-invariant).
    """
    a12 = jnp.roll(atlas, -1, axis=2)
    a21 = jnp.roll(atlas, -1, axis=1)
    a22 = jnp.roll(a21, -1, axis=2)
    return jnp.concatenate([atlas, a12, a21, a22], axis=-1)


def sample_atlas(atlas: jnp.ndarray, tex_id: jnp.ndarray, u: jnp.ndarray,
                 v: jnp.ndarray) -> jnp.ndarray:
    """Sample atlas (T, H, W, 3) at per-lane texture ids.

    Same math as :func:`sample_bilinear_wrap` (the reference's exact
    bilinear + wrap rule) but via :func:`pack_atlas_2x2`, so each lane costs
    ONE 12-float gather from the flattened packed atlas.  Negative ids are
    clipped to 0; callers select the flat colour for those lanes.
    """
    t_, rows, cols, _ = atlas.shape
    tid = jnp.clip(tex_id, 0, t_ - 1)
    row = (u - jnp.floor(u)) * rows
    col = (v - jnp.floor(v)) * cols
    r1 = jnp.floor(row + 1e-10).astype(jnp.int32)
    c1 = jnp.floor(col + 1e-10).astype(jnp.int32)
    det_r = (r1 + 1 - row)[..., None]
    det_c = (c1 + 1 - col)[..., None]
    r1 = jnp.where(r1 >= 0, jnp.where(r1 >= rows, 0, r1), rows - 1)
    c1 = jnp.where(c1 >= 0, jnp.where(c1 >= cols, 0, c1), cols - 1)
    packed = pack_atlas_2x2(atlas).reshape(t_ * rows * cols, 12)
    quad = packed[tid * (rows * cols) + r1 * cols + c1]    # (..., 12)
    return (
        quad[..., 0:3] * det_r * det_c
        + quad[..., 3:6] * det_r * (1.0 - det_c)
        + quad[..., 6:9] * (1.0 - det_r) * det_c
        + quad[..., 9:12] * (1.0 - det_r) * (1.0 - det_c)
    )


# ---------------------------------------------------------------------------
# Procedural stand-ins for the reference assets (deterministic, file-free).
# ---------------------------------------------------------------------------

def checker(res: int = 256, tiles: int = 8, c0=(0.9, 0.9, 0.9), c1=(0.1, 0.1, 0.1)) -> np.ndarray:
    y, x = np.mgrid[0:res, 0:res]
    m = (((y * tiles // res) + (x * tiles // res)) % 2).astype(np.float32)
    return (np.outer(1 - m, c0) + np.outer(m, c1)).reshape(res, res, 3).astype(np.float32)


def bricks(res: int = 256) -> np.ndarray:
    """Wall-like brick pattern (stand-in for wall.jpg)."""
    y, x = np.mgrid[0:res, 0:res].astype(np.float32) / res
    row = np.floor(y * 8)
    xs = x + 0.5 * (row % 2)
    mortar = ((np.abs((y * 8) % 1.0) < 0.08) | (np.abs((xs * 4) % 1.0) < 0.05))
    base = np.stack([0.62 + 0.08 * np.sin(37 * x + 11 * y), 0.32 * np.ones_like(x), 0.26 * np.ones_like(x)], -1)
    out = np.where(mortar[..., None], np.array([0.75, 0.73, 0.7]), base)
    return out.astype(np.float32)


def planet(res: int = 256, seed: int = 7) -> np.ndarray:
    """Banded-noise planet (stand-in for planet.jpg)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:res, 0:res].astype(np.float32) / res
    val = np.zeros((res, res), np.float32)
    for octave in range(1, 5):
        f = 2.0**octave
        ph = rng.uniform(0, 2 * np.pi, 2)
        val += np.sin(2 * np.pi * f * y + ph[0]) * np.cos(2 * np.pi * f * x + ph[1]) / f
    val = (val - val.min()) / (np.ptp(val) + 1e-9)
    a = np.array([0.85, 0.65, 0.4], np.float32)
    b = np.array([0.3, 0.45, 0.6], np.float32)
    return (val[..., None] * a + (1 - val[..., None]) * b).astype(np.float32)


def marble(res: int = 256) -> np.ndarray:
    """Marble-ish veins (stand-in for timg.jpg floor)."""
    y, x = np.mgrid[0:res, 0:res].astype(np.float32) / res
    v = 0.5 + 0.5 * np.sin(14 * x + 6 * np.sin(9 * y + 3 * np.sin(5 * x)))
    base = 0.55 + 0.4 * v
    return np.stack([base, base * 0.98, base * 0.95], -1).astype(np.float32)


def flat(res: int = 256, color=(0.2, 0.4, 0.9)) -> np.ndarray:
    return np.broadcast_to(np.asarray(color, np.float32), (res, res, 3)).copy()


def load_image(path: str, res: int = 256) -> np.ndarray:
    """Load an image file into a (res, res, 3) float32 RGB array in [0, 1].

    Needs Pillow, which the render path does not: the built-in scenes use
    procedural textures."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            "load_image needs Pillow (pip install pillow) to decode image "
            "files; the procedural textures in this module do not") from e

    img = Image.open(path).convert("RGB").resize((res, res), Image.BILINEAR)
    return np.asarray(img, np.float32) / 255.0


def build_atlas(textures: list[np.ndarray]) -> jnp.ndarray:
    """Stack equal-resolution textures into the (T, H, W, 3) device atlas."""
    if not textures:
        return jnp.ones((1, 4, 4, 3), jnp.float32)
    return jnp.asarray(np.stack(textures, 0), jnp.float32)
