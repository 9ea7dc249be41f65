"""Driver tests: multi-pass determinism, checkpoint/resume exactness,
CLI smoke (reference has none of this — SURVEY.md section 5)."""

import os

import jax
import numpy as np

from raytrace3_tpu.render import driver
from raytrace3_tpu.utils.config import RenderConfig, get_config

TINY = RenderConfig(
    scene="cornell_diffuse", width=24, height=24, passes=3, rounds=2,
    photons_per_round=512, max_depth=4, atlas_res=16,
)


def test_render_deterministic(tmp_path):
    img1, m1 = driver.render(TINY)
    img2, m2 = driver.render(TINY)
    np.testing.assert_array_equal(img1, img2)
    assert img1.shape == (24, 24, 3)
    assert np.isfinite(img1).all() and img1.max() > 0


def test_checkpoint_resume_exact(tmp_path):
    ck = str(tmp_path / "ck.npz")
    full_img, _ = driver.render(TINY)

    # run only 1 pass, checkpointing
    cfg1 = TINY.replace(passes=1, checkpoint_every=1)
    driver.render(cfg1, checkpoint_path=ck)
    # resume to 3 passes from the checkpoint
    resumed_img, _ = driver.render(TINY.replace(checkpoint_every=1),
                                   checkpoint_path=ck)
    np.testing.assert_allclose(resumed_img, full_img, rtol=1e-6, atol=1e-7)


def test_seed_changes_image():
    img1, _ = driver.render(TINY)
    img2, _ = driver.render(TINY.replace(seed=123))
    assert np.abs(img1 - img2).max() > 1e-6


def test_presets_exist():
    for name in ["cornell128", "specular256", "bezier256", "teapot512",
                 "sharded10m", "bench512", "reference1024"]:
        cfg = get_config(name)
        assert cfg.n_pixels > 0


def test_cli_smoke(tmp_path, monkeypatch):
    # keep the persistent compile cache out of the checkout
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "cache"))
    out = str(tmp_path / "o.png")
    from raytrace3_tpu.cli import main

    rc = main([
        "--scene", "cornell_diffuse", "--res", "16", "--passes", "1",
        "--rounds", "1", "--photons", "256", "--depth", "3",
        "--out", out,
    ])
    assert rc == 0
    assert os.path.exists(out)
    import struct

    with open(out, "rb") as f:
        head = f.read(24)
    assert head[:8] == b"\x89PNG\r\n\x1a\n" and head[12:16] == b"IHDR"
    assert struct.unpack(">II", head[16:24]) == (16, 16)


def test_two_light_scene_renders():
    cfg = TINY.replace(scene="cornell_two_lights", passes=1)
    img, m = driver.render(cfg)
    assert np.isfinite(img).all() and img.max() > 0


def test_psnr_util():
    from raytrace3_tpu.utils.image import mse, psnr

    a = np.zeros((4, 4, 3)); b = np.ones((4, 4, 3)) * 0.1
    assert abs(mse(a, b) - 0.01) < 1e-12
    assert abs(psnr(a, b) - 20.0) < 1e-9
    assert psnr(a, a) == float("inf")


def test_photon_regen_consistent_estimator():
    """Regenerated-lane photon walks must estimate the SAME image as the
    idle-lane walk (both unbiased over emitted photons): compare two
    renders of the diffuse box at matched emitted-photon counts."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from raytrace3_tpu import emit_rays, get_scene, render_pass
    from raytrace3_tpu.scenes import reference_camera

    scene = get_scene("cornell_diffuse", atlas_res=32)
    cam = reference_camera(48, 48)
    org, dir = emit_rays(cam)

    def render(regen, k):
        img, stats = jax.jit(
            lambda kk: render_pass(
                scene, org, dir, kk, hitpoint_capacity=48 * 48 * 2,
                n_rounds=6, photons_per_round=4096, photon_regen=regen,
            )
        )(k)
        return np.asarray(img), stats

    img_a, st_a = render(False, jax.random.key(3))
    img_a2, _ = render(False, jax.random.key(11))
    img_b, st_b = render(True, jax.random.key(4))
    assert float(st_a["photons_emitted"]) == 6 * 4096
    # regen packs MORE photons through the same lanes
    assert float(st_b["photons_emitted"]) > 1.5 * 6 * 4096
    assert not np.isnan(img_b).any()
    # same expectation: mean radiance agrees within Monte-Carlo noise
    ma, mb = img_a.mean(), img_b.mean()
    assert abs(ma - mb) / ma < 0.08, (ma, mb)
    # pixelwise, regen-vs-baseline must look like one more INDEPENDENT
    # sample of the same image: correlate at least as well as two
    # independent baseline renders do with each other (the MC noise floor
    # at this photon count is itself only ~0.74).
    c = lambda x, y: np.corrcoef(x.reshape(-1), y.reshape(-1))[0, 1]
    floor = c(img_a, img_a2)
    ca = c(img_a, img_b)
    assert ca > floor - 0.05, (ca, floor)


def test_photon_regen_two_lights_consistent_estimator():
    """Two lights with DIFFERENT colours/positions (so their photons die at
    different rates): the regen estimator must still match the static-lane
    estimator.  Round 1's positional lane->light refill over-emitted from
    short-lived lights while normalising by the per-light average, which
    skews the colour balance; the round-robin refill keeps per-light emitted
    counts equal to within one photon (render/photon.py)."""
    import jax
    import numpy as np

    from raytrace3_tpu import emit_rays, get_scene, render_pass
    from raytrace3_tpu.scenes import reference_camera

    scene = get_scene("cornell_two_lights", atlas_res=32)
    cam = reference_camera(48, 48)
    org, dir = emit_rays(cam)

    def render(regen, k):
        img, stats = jax.jit(
            lambda kk: render_pass(
                scene, org, dir, kk, hitpoint_capacity=48 * 48 * 2,
                n_rounds=6, photons_per_round=4096, photon_regen=regen,
            )
        )(k)
        return np.asarray(img), stats

    img_a, st_a = render(False, jax.random.key(3))
    img_a2, _ = render(False, jax.random.key(11))
    img_b, st_b = render(True, jax.random.key(4))
    assert float(st_b["photons_emitted"]) > 1.5 * 6 * 4096
    assert not np.isnan(img_b).any()
    # the two lights have different colours, so a per-light normalisation
    # error shows up as a CHANNEL-BALANCE shift: check each channel's mean
    ma, mb = img_a.mean(0).mean(0), img_b.mean(0).mean(0)
    noise = np.abs(img_a - img_a2).mean() / img_a.mean()  # MC floor
    rel = np.abs(ma - mb) / ma
    assert rel.max() < 0.08, (ma, mb, rel, noise)
    c = lambda x, y: np.corrcoef(x.reshape(-1), y.reshape(-1))[0, 1]
    floor = c(img_a, img_a2)
    assert c(img_a, img_b) > floor - 0.05, (c(img_a, img_b), floor)


def test_photon_regen_per_light_counts_balanced():
    """The round-robin refill keeps per-light emitted counts equal to within
    ONE photon across rounds, by construction — the deterministic invariant
    behind the two-light statistical test above.  (With the old positional
    lane->light binding this scene measured a ~7% imbalance.)"""
    import jax
    import numpy as np

    from raytrace3_tpu import get_scene
    from raytrace3_tpu.render.photon import photon_trace_regen

    scene = get_scene("cornell_two_lights", atlas_res=16)
    st, key = None, jax.random.key(0)
    total = np.zeros(2)
    for _ in range(5):
        key, k = jax.random.split(key)
        _, st, e = photon_trace_regen(
            scene, k, scene.light_pos, scene.light_color, 1024, st,
            max_depth=13)
        total += np.asarray(e)
    assert total.sum() > 5 * 1024  # regen actually packed extra photons
    assert abs(total[0] - total[1]) <= 1.0, total


def test_train_state_checkpoint_roundtrip(tmp_path):
    """save_tree/load_tree restore (params, opt_state) bitwise (SURVEY.md
    section 5 checkpoint plan — the reference cannot resume at all)."""
    import optax

    from raytrace3_tpu.diff.train import extract_params, make_train_step
    from raytrace3_tpu.utils import checkpoint as ckpt

    cfg = RenderConfig(scene="cornell_diffuse", width=12, height=12,
                       passes=1, rounds=1, photons_per_round=256,
                       max_depth=3, atlas_res=8)
    scene = driver.build_scene(cfg)
    init_fn, step_fn = make_train_step(scene, cfg, optax.adam(1e-2))
    params = extract_params(scene)
    opt_state = init_fn(params)
    key = jax.random.key(0)
    target = np.zeros((cfg.height, cfg.width, 3), np.float32)
    params, opt_state, _, _ = step_fn(params, opt_state, key, target)

    path = str(tmp_path / "train.npz")
    ckpt.save_tree(path, {"params": params, "opt": opt_state}, step=1)
    template = {"params": jax.tree.map(np.zeros_like, params),
                "opt": jax.tree.map(np.zeros_like, opt_state)}
    restored, step = ckpt.load_tree(path, template)
    assert step == 1
    for got, want in zip(jax.tree.leaves(restored),
                         jax.tree.leaves({"params": params, "opt": opt_state})):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))

    # a step from the restored state matches a step from the live state
    p1, _, l1, _ = step_fn(params, opt_state, key, target)
    p2, _, l2, _ = step_fn(restored["params"], restored["opt"], key, target)
    np.testing.assert_allclose(float(l1), float(l2), rtol=1e-6)
    for a, b in zip(jax.tree.leaves(p1), jax.tree.leaves(p2)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6)
