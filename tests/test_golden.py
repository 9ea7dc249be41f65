"""Golden/integration tests (SURVEY.md section 4):

1. A straightforward numpy transcription of the reference estimator
   (recursive ViewTrace/PhotonTrace, fixed-radius deposits) renders the
   diffuse Cornell config; our vectorised renderer must agree statistically
   (both are Monte Carlo estimators of the same integral with the same
   estimator quirks).
2. Deposit backends (bruteforce oracle vs the banded Triton kernel) must
   produce the same image inside a full render pass.
3. A fixed-key golden hash guards against silent estimator drift.
"""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytrace3_tpu.render.camera import emit_rays, look_at
from raytrace3_tpu.render.deposit import deposit_bruteforce
from raytrace3_tpu.render.driver import build_scene
from raytrace3_tpu.render.sppm import render_pass
from raytrace3_tpu.utils.config import RenderConfig

CFG = RenderConfig(
    scene="cornell_diffuse", width=32, height=32, rounds=8,
    photons_per_round=8192, max_depth=6, atlas_res=16,
    update_mode="reference",  # fixed radius: unbiased fixed-kernel estimator
)


# ---------------------------------------------------------------------------
# numpy port of the reference estimator (diffuse-only path), scalar and slow
# ---------------------------------------------------------------------------

def _np_render(res=32, rounds=8, photons=8192, max_depth=6, seed=0):
    rng = np.random.default_rng(seed)

    # scene: 5 planes + 3 spheres, all diffuse (scenes.cornell_diffuse)
    p0 = np.array([[1, 40.8, 81.6], [99, 40.8, 81.6], [50, 40.8, 0],
                   [50, 0, 81.6], [50, 81.6, 81.6]], float)
    pn = np.array([[1, 0, 0], [1, 0, 0], [0, 0, 1], [0, -1, 0], [0, 1, 0]],
                  float)
    sc = np.array([[27, 16.5, 47], [73, 16.5, 88], [50, 8.5, 60]], float)
    sr = np.array([16.5, 16.5, 8.5])
    albedo = np.array([
        [0.75, 0.3, 0.3], [0.3, 0.3, 0.75], [0.75, 0.75, 0.75],
        [0.75, 0.75, 0.75], [0.75, 0.75, 0.75],
        [0.75, 0.75, 0.75], [0.75, 0.75, 0.75], [0.75, 0.75, 0.75]])
    color = np.array([
        [0.75, 0.25, 0.25], [0.25, 0.25, 0.75], [0.75, 0.75, 0.75],
        [0.75, 0.75, 0.75], [0.75, 0.75, 0.75],
        [0.999] * 3, [0.999] * 3, [0.999] * 3])
    light = np.array([50.0, 60.0, 85.0])
    lcol = np.array([5000.0] * 3)

    def nearest(o, d):
        best = (1e18, -1, None, None)
        for i in range(5):
            pr = d @ pn[i]
            if abs(pr) < 1e-4:
                continue
            t = (p0[i] - o) @ pn[i] / pr
            if 1e-4 < t < best[0]:
                best = (t, i, o + t * d, pn[i])
        for j in range(3):
            L = sc[j] - o
            pr = L @ d
            det2 = sr[j] ** 2 - (L @ L - pr**2)
            if det2 < 1e-4:
                continue
            dt = np.sqrt(det2)
            t1, t2 = pr - dt, pr + dt
            if t2 < 1e-4:
                continue
            t = t2 if t1 < 1e-4 else t1
            if t < best[0]:
                p = o + t * d
                best = (t, 5 + j, p, (p - sc[j]) / np.linalg.norm(p - sc[j]))
        return best

    # eye pass: all-diffuse -> depth-1 recording only
    cam_pos = np.array([50.0, 35.0, 230.0])
    cam = look_at(jnp.asarray(cam_pos, jnp.float32),
                  jnp.asarray(cam_pos + [0, 0.042612, -1], jnp.float32),
                  res, res)
    org, dirs = map(np.asarray, emit_rays(cam))

    hp_pos, hp_n, hp_wgt, hp_px = [], [], [], []
    for i in range(res * res):
        t, obj, p, n = nearest(org[i], dirs[i])
        if obj < 0:
            continue
        hp_pos.append(p)
        hp_n.append(n)
        hp_wgt.append(color[obj] * albedo[obj])
        hp_px.append(i)
    hp_pos = np.array(hp_pos); hp_n = np.array(hp_n)
    hp_wgt = np.array(hp_wgt); hp_px = np.array(hp_px)
    tao = np.zeros_like(hp_wgt)

    def cosine(n):
        u1, u2 = rng.uniform(), rng.uniform()
        ct, st = np.sqrt(u1), np.sqrt(1 - u1)
        phi = 2 * np.pi * u2
        a = np.array([0, 1, 0]) if abs(n[0]) > 0.1 else np.array([1, 0, 0])
        t = np.cross(a, n); t /= np.linalg.norm(t)
        b = np.cross(n, t)
        return t * st * np.cos(phi) + b * st * np.sin(phi) + n * ct

    nphot = rounds * photons
    for _ in range(nphot):
        z = rng.uniform(-1, 1); phi = rng.uniform(0, 2 * np.pi)
        r = np.sqrt(max(0.0, 1 - z * z))
        d = np.array([r * np.cos(phi), r * np.sin(phi), z])
        o = light.copy()
        flux = lcol * 4 * np.pi
        for dep in range(max_depth + 1):
            t, obj, p, n = nearest(o, d)
            if obj < 0:
                break
            dv = hp_pos - p
            m = (hp_n @ n > 1e-3) & ((dv * dv).sum(1) <= 2.0)
            tao[m] += hp_wgt[m] * flux / np.pi
            # diffuse-only scene: roulette always picks DIFF
            flux = flux * color[obj]
            o, d = p, cosine(n)
    img = np.zeros((res * res, 3))
    np.add.at(img, hp_px, tao / (np.pi * 2.0 * nphot))
    return img.reshape(res, res, 3)


@pytest.mark.slow
def test_matches_numpy_reference_port(key):
    scene = build_scene(CFG)
    cam = look_at(jnp.asarray([50.0, 35.0, 230.0], jnp.float32),
                  jnp.asarray([50.0, 35.042612, 229.0], jnp.float32),
                  CFG.width, CFG.height)
    org, dirs = emit_rays(cam)
    ours, _ = jax.jit(lambda k: render_pass(
        scene, org, dirs, k, hitpoint_capacity=CFG.hitpoint_capacity,
        n_rounds=CFG.rounds, photons_per_round=CFG.photons_per_round,
        max_depth=CFG.max_depth, update_mode="reference"))(key)
    ours = np.asarray(ours).reshape(CFG.height, CFG.width, 3)

    ref = _np_render(CFG.width, CFG.rounds, CFG.photons_per_round,
                     CFG.max_depth)

    # Two independent MC estimates of the same quantity: compare means over
    # coarse blocks (8x8 pixel tiles) to suppress MC noise.
    def pool(a):
        return a.reshape(4, 8, 4, 8, 3).mean((1, 3))

    po, pr = pool(ours), pool(ref)
    mask = pr.mean(-1) > 0.05  # skip near-black tiles
    rel = np.abs(po - pr)[mask] / (pr[mask] + 0.05)
    assert rel.mean() < 0.2, (rel.mean(), rel.max())


def test_banded_and_bruteforce_render_identically(key):
    """The banded Triton deposit (Pallas interpreter) inside a full render
    pass, including its layout-space rounds, against the bruteforce
    oracle."""
    from raytrace3_tpu.ops.deposit_pallas import BandedDeposit

    scene = build_scene(CFG)
    cam = look_at(jnp.asarray([50.0, 35.0, 230.0], jnp.float32),
                  jnp.asarray([50.0, 35.042612, 229.0], jnp.float32),
                  CFG.width, CFG.height)
    org, dirs = emit_rays(cam)

    def run(dep_fn):
        img, _ = jax.jit(lambda k: render_pass(
            scene, org, dirs, k, hitpoint_capacity=CFG.hitpoint_capacity,
            n_rounds=2, photons_per_round=2048, max_depth=4,
            deposit_fn=dep_fn))(key)
        return np.asarray(img)

    a = run(deposit_bruteforce)
    b = run(BandedDeposit(tile=64, chunk=64, x_lo=-4.0, x_hi=104.0,
                          interpret=True))
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)


def test_fixed_key_golden_hash(key):
    """Guards the whole pipeline against silent numerical drift.  If this
    changes INTENTIONALLY (algorithm improvement), update the hash."""
    scene = build_scene(CFG)
    cam = look_at(jnp.asarray([50.0, 35.0, 230.0], jnp.float32),
                  jnp.asarray([50.0, 35.042612, 229.0], jnp.float32),
                  16, 16)
    org, dirs = emit_rays(cam)
    img, _ = jax.jit(lambda k: render_pass(
        scene, org, dirs, k, hitpoint_capacity=512,
        n_rounds=2, photons_per_round=1024, max_depth=4))(key)
    img8 = np.asarray(jnp.round(img * 1e4).astype(jnp.int32))
    h = hashlib.sha256(img8.tobytes()).hexdigest()[:16]
    # Regeneration is ONLY allowed behind an explicit env flag — a missing
    # golden file must FAIL, not self-heal to whatever the code now produces.
    import os
    golden_file = os.path.join(os.path.dirname(__file__), "golden_hash.txt")
    if not os.path.exists(golden_file):
        if os.environ.get("RT3_REGEN_GOLDEN") == "1":
            with open(golden_file, "w") as f:
                f.write(h + "\n")
        else:
            pytest.fail(
                "tests/golden_hash.txt is missing; re-record it explicitly "
                "with RT3_REGEN_GOLDEN=1 after verifying the change"
            )
    with open(golden_file) as f:
        want = f.read().strip()
    assert h == want, f"pipeline output drifted: {h} != {want}"
