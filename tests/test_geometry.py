"""Geometry unit tests: analytic plane/sphere cases, AABB vs brute force,
texture bilinear vs scipy (reference behaviours cited from raytracer/Obj.h,
Bezier.h, Element.h)."""

import jax
import jax.numpy as jnp
import numpy as np

from raytrace3_tpu.core.vecmath import MAX_DIST
from raytrace3_tpu.geometry.aabb import aabb_from_points, slab_test
from raytrace3_tpu.geometry.plane import intersect_planes, make_planes, plane_uv
from raytrace3_tpu.geometry.sphere import intersect_spheres, make_spheres
from raytrace3_tpu.textures.texture import sample_bilinear_wrap


class TestPlane:
    def test_axis_plane_hit(self):
        planes = make_planes([(0, 0, 5)], [(0, 0, 1)])
        org = jnp.asarray([[0.0, 0.0, 0.0], [0.0, 0.0, 10.0], [0.0, 0.0, 0.0]])
        dir = jnp.asarray([[0.0, 0.0, 1.0], [0.0, 0.0, -1.0], [1.0, 0.0, 0.0]])
        t, hit = intersect_planes(org, dir, planes)
        np.testing.assert_allclose(np.asarray(t)[:2, 0], [5.0, 5.0], rtol=1e-6)
        assert not bool(hit[2, 0])  # parallel ray misses (Obj.h:69)

    def test_behind_origin_misses(self):
        planes = make_planes([(0, 0, 5)], [(0, 0, 1)])
        t, hit = intersect_planes(
            jnp.asarray([[0.0, 0.0, 10.0]]), jnp.asarray([[0.0, 0.0, 1.0]]), planes
        )
        assert not bool(hit[0, 0])
        assert float(t[0, 0]) >= MAX_DIST * 0.99

    def test_oblique_hit_distance(self):
        planes = make_planes([(0, 0, 2)], [(0, 0, 1)])
        d = jnp.asarray([[0.6, 0.0, 0.8]])
        t, hit = intersect_planes(jnp.zeros((1, 3)), d, planes)
        np.testing.assert_allclose(float(t[0, 0]), 2.0 / 0.8, rtol=1e-6)

    def test_uv_swap_quirk(self):
        """u is scaled by |texV|=300 and v by |texU|=400 (Obj.h:97-98)."""
        planes = make_planes([(0, 0, 0)], [(0, 1, 0)])  # ndir=1, udex=2, vdex=0
        pos = jnp.asarray([[40.0, 0.0, 30.0]])
        u, v = plane_uv(pos, planes, jnp.asarray([0]))
        np.testing.assert_allclose(float(u[0]), 0.5 + 30.0 / 300.0, rtol=1e-5)
        np.testing.assert_allclose(float(v[0]), 0.5 + 40.0 / 400.0, rtol=1e-5)


class TestSphere:
    def test_outside_hit_near_root(self):
        s = make_spheres([(0, 0, 10)], [2.0])
        t, hit, inside = intersect_spheres(
            jnp.zeros((1, 3)), jnp.asarray([[0.0, 0.0, 1.0]]), s
        )
        assert bool(hit[0, 0]) and not bool(inside[0, 0])
        np.testing.assert_allclose(float(t[0, 0]), 8.0, rtol=1e-6)

    def test_inside_hit_far_root(self):
        s = make_spheres([(0, 0, 0)], [2.0])
        t, hit, inside = intersect_spheres(
            jnp.zeros((1, 3)), jnp.asarray([[0.0, 0.0, 1.0]]), s
        )
        assert bool(hit[0, 0]) and bool(inside[0, 0])
        np.testing.assert_allclose(float(t[0, 0]), 2.0, rtol=1e-6)

    def test_miss(self):
        s = make_spheres([(0, 5, 10)], [2.0])
        t, hit, _ = intersect_spheres(
            jnp.zeros((1, 3)), jnp.asarray([[0.0, 0.0, 1.0]]), s
        )
        assert not bool(hit[0, 0])

    def test_behind(self):
        s = make_spheres([(0, 0, -10)], [2.0])
        _, hit, _ = intersect_spheres(
            jnp.zeros((1, 3)), jnp.asarray([[0.0, 0.0, 1.0]]), s
        )
        assert not bool(hit[0, 0])

    def test_grazing_tangent_rejected(self):
        """det2 < M_EPS is a miss (Obj.h:117)."""
        s = make_spheres([(0, 2, 10)], [2.0])
        _, hit, _ = intersect_spheres(
            jnp.zeros((1, 3)), jnp.asarray([[0.0, 0.0, 1.0]]), s
        )
        assert not bool(hit[0, 0])


class TestAABB:
    def test_vs_bruteforce(self, rng):
        pts = rng.uniform(-1, 1, size=(8, 3)).astype(np.float32)
        pmin, pmax = aabb_from_points(jnp.asarray(pts))
        np.testing.assert_allclose(np.asarray(pmin), pts.min(0))
        np.testing.assert_allclose(np.asarray(pmax), pts.max(0))

        org = rng.uniform(-5, 5, size=(256, 3)).astype(np.float32)
        dir = rng.normal(size=(256, 3)).astype(np.float32)
        dir /= np.linalg.norm(dir, axis=-1, keepdims=True)
        got = np.asarray(slab_test(jnp.asarray(org), jnp.asarray(dir), pmin, pmax))

        # brute force: sample many t, check box membership
        ts = np.linspace(0, 20, 4001)[None, :, None]
        p = org[:, None, :] + ts * dir[:, None, :]
        inbox = ((p >= pts.min(0) - 1e-6) & (p <= pts.max(0) + 1e-6)).all(-1).any(-1)
        # slab test may also accept exact-boundary grazers brute force misses
        assert (got | ~inbox).all()  # no false negatives
        assert (got == inbox).mean() > 0.98

    def test_ray_inside_box(self):
        pmin = jnp.asarray([-1.0, -1.0, -1.0])
        pmax = jnp.asarray([1.0, 1.0, 1.0])
        hit = slab_test(jnp.zeros((1, 3)), jnp.asarray([[1.0, 0.0, 0.0]]), pmin, pmax)
        assert bool(hit[0])

    def test_axis_parallel_ray(self):
        pmin = jnp.asarray([2.0, -1.0, -1.0])
        pmax = jnp.asarray([3.0, 1.0, 1.0])
        hit = slab_test(
            jnp.asarray([[0.0, 0.0, 0.0]]), jnp.asarray([[1.0, 0.0, 0.0]]), pmin, pmax
        )
        assert bool(hit[0])
        miss = slab_test(
            jnp.asarray([[0.0, 5.0, 0.0]]), jnp.asarray([[1.0, 0.0, 0.0]]), pmin, pmax
        )
        assert not bool(miss[0])


class TestTexture:
    def test_bilinear_matches_scipy(self, rng):
        from scipy.ndimage import map_coordinates

        tex = rng.uniform(size=(32, 48, 3)).astype(np.float32)
        u = rng.uniform(0.02, 0.95, size=200).astype(np.float32)
        v = rng.uniform(0.02, 0.95, size=200).astype(np.float32)
        got = np.asarray(
            sample_bilinear_wrap(jnp.asarray(tex), jnp.asarray(u), jnp.asarray(v))
        )
        # interior points: plain bilinear at (u*rows, v*cols) with the
        # reference's convention that texel centres sit at integer coords
        want = np.stack(
            [
                map_coordinates(tex[..., c], [u * 32, v * 48], order=1, mode="grid-wrap")
                for c in range(3)
            ],
            -1,
        )
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)

    def test_wraparound(self):
        tex = jnp.asarray(np.arange(12, dtype=np.float32).reshape(2, 2, 3))
        a = np.asarray(sample_bilinear_wrap(tex, jnp.asarray([0.3]), jnp.asarray([0.7])))
        b = np.asarray(
            sample_bilinear_wrap(tex, jnp.asarray([1.3]), jnp.asarray([-0.3]))
        )
        np.testing.assert_allclose(a, b, rtol=1e-5)

    def test_load_image_roundtrip(self, tmp_path):
        """The real-asset path (Element.h:47-59's cv::imread equivalent):
        write a PNG, load it back resampled, values land in [0,1]."""
        from PIL import Image

        from raytrace3_tpu.textures.texture import load_image

        src = (np.mgrid[0:16, 0:16].sum(0) % 2 * 255).astype(np.uint8)
        rgb = np.stack([src, np.zeros_like(src), 255 - src], -1)
        p = tmp_path / "wall.png"
        Image.fromarray(rgb).save(p)
        got = load_image(str(p), res=16)
        assert got.shape == (16, 16, 3) and got.dtype == np.float32
        np.testing.assert_allclose(got, rgb.astype(np.float32) / 255.0,
                                   atol=1e-3)

    def test_atlas_uses_asset_dir(self, tmp_path):
        """RT3_ASSET_TEXTURES overrides procedural atlas slots with files."""
        from PIL import Image

        from raytrace3_tpu import scenes

        solid = np.full((8, 8, 3), [255, 128, 0], np.uint8)
        Image.fromarray(solid).save(tmp_path / "planet.png")
        atlas = np.asarray(scenes._atlas(8, asset_dir=str(tmp_path)))
        np.testing.assert_allclose(
            atlas[2], solid.astype(np.float32) / 255.0, atol=1e-3)
        # untouched slots stay procedural
        np.testing.assert_allclose(atlas[1], np.asarray(scenes.tx.marble(8)))


class TestCamera:
    def test_reference_basis(self):
        """lookAt basis for the main.cpp pose (Camera.h:32-54): up=(0,0,1),
        du = unit(dir x up), dv = unit(-dir x du), |dir| = 0.5/tan(25 deg)."""
        from raytrace3_tpu.render.camera import emit_rays, look_at

        pos = np.array([50.0, 35.0, 230.0])
        look = pos + np.array([0.0, 0.042612, -1.0])
        cam = look_at(jnp.asarray(pos, jnp.float32),
                      jnp.asarray(look, jnp.float32), 8, 8)
        d = (look - pos) / np.linalg.norm(look - pos)
        du = np.cross(d, [0, 0, 1]); du /= np.linalg.norm(du)
        dv = -np.cross(d, du); dv /= np.linalg.norm(dv)
        scale = 0.5 / np.tan(np.deg2rad(25.0))
        np.testing.assert_allclose(np.asarray(cam.du), du, atol=1e-5)
        np.testing.assert_allclose(np.asarray(cam.dv), dv, atol=1e-5)
        np.testing.assert_allclose(np.asarray(cam.dir), d * scale, atol=1e-5)

        org, dirs = emit_rays(cam)
        assert org.shape == (64, 3) and dirs.shape == (64, 3)
        np.testing.assert_allclose(np.linalg.norm(np.asarray(dirs), axis=1),
                                   1.0, rtol=1e-5)
        # center of pixel (y=4, x=4) ray: d = du*((4.5)/8-.5)+dv*((4.5)/8-.5)+dir
        want = du * (4.5 / 8 - 0.5) + dv * (4.5 / 8 - 0.5) + d * scale
        want /= np.linalg.norm(want)
        np.testing.assert_allclose(np.asarray(dirs[4 * 8 + 4]), want,
                                   atol=1e-5)


def test_hot_contractions_are_highest_precision():
    """Regression guard for a reduced-precision brightness bug: a bf16
    (or TF32) default matmul precision rounds the plane-intersection t
    values (~150 +- 0.6) and one-hot-fetched table values, putting bounce
    origins ~half a unit off every surface — spurious self-re-intersections
    inflated renders ~1.27x (found by crossval against the C++ oracle and a
    numpy reference port; CPU tests can never see it because the CPU
    backend is always f32).  Every geometry/table contraction must carry an
    explicit HIGHEST precision, which this test checks in the traced jaxpr
    (the only way to cover an accelerator-only numeric on CPU)."""
    import jax
    import jax.numpy as jnp

    from raytrace3_tpu.geometry.plane import intersect_planes, make_planes
    from raytrace3_tpu.geometry.sphere import intersect_spheres, make_spheres
    from raytrace3_tpu.ops.onehot import take_rows

    org = jnp.zeros((8, 3)); dirs = jnp.ones((8, 3))
    planes = make_planes(jnp.zeros((2, 3)).at[:, 1].set(1.0),
                         jnp.zeros((2, 3)).at[:, 1].set(1.0))
    spheres = make_spheres(jnp.ones((2, 3)), jnp.ones((2,)))
    tbl = jnp.arange(12.0).reshape(4, 3)
    idx = jnp.zeros((8,), jnp.int32)

    for name, fn, args in [
        ("plane", intersect_planes, (org, dirs, planes)),
        ("sphere", intersect_spheres, (org, dirs, spheres)),
        ("take_rows", take_rows, (tbl, idx)),
    ]:
        jaxpr = str(jax.make_jaxpr(fn)(*args))
        assert "dot_general" in jaxpr, (name, "expected a contraction")
        # every dot_general in these fns must be HIGHEST
        import re
        for m in re.finditer(r"precision=\(?([A-Za-z.]+)", jaxpr):
            assert "HIGHEST" in m.group(1).upper(), (name, m.group(1))
        assert "Highest" in jaxpr or "HIGHEST" in jaxpr, name
