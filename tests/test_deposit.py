"""Deposit-op tests: the banded Triton kernel (in the Pallas interpreter)
must agree exactly with the brute-force all-pairs oracle (which itself
mirrors the reference's kd-tree semantics, raytracer/Raytracer.h:144-159)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytrace3_tpu.core.types import Deposits, make_hitpoints
from raytrace3_tpu.render.deposit import deposit_bruteforce


def _random_case(rng, C=300, D=700):
    hp = make_hitpoints(C, init_r2=2.0)
    pos = rng.uniform(0, 40, size=(C, 3)).astype(np.float32)
    n = rng.normal(size=(C, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    wgt = rng.uniform(0, 1, size=(C, 3)).astype(np.float32)
    valid = rng.uniform(size=C) > 0.1
    r2 = rng.uniform(0.5, 2.0, size=C).astype(np.float32)
    hp = hp.replace(
        pos=jnp.asarray(pos), n=jnp.asarray(n), wgt=jnp.asarray(wgt),
        valid=jnp.asarray(valid), r2=jnp.asarray(r2),
    )
    dpos = rng.uniform(0, 40, size=(D, 3)).astype(np.float32)
    dn = rng.normal(size=(D, 3)).astype(np.float32)
    dn /= np.linalg.norm(dn, axis=-1, keepdims=True)
    dep = Deposits(
        pos=jnp.asarray(dpos),
        n=jnp.asarray(dn),
        flux=jnp.asarray(rng.uniform(0, 5, size=(D, 3)).astype(np.float32)),
        valid=jnp.asarray(rng.uniform(size=D) > 0.2),
    )
    return hp, dep


def _numpy_oracle(hp, dep):
    """Direct transcription of the reference neighbour filter."""
    pos = np.asarray(hp.pos); n = np.asarray(hp.n); r2 = np.asarray(hp.r2)
    wgt = np.asarray(hp.wgt); hv = np.asarray(hp.valid)
    dp = np.asarray(dep.pos); dn = np.asarray(dep.n)
    df = np.asarray(dep.flux); dv = np.asarray(dep.valid)
    d2 = ((pos[:, None, :] - dp[None, :, :]) ** 2).sum(-1)
    ndot = n @ dn.T
    m = (d2 <= r2[:, None]) & (ndot > 1e-3) & dv[None, :] & hv[:, None]
    cnt = m.sum(1).astype(np.float32)
    tao = wgt * (m.astype(np.float32) @ df) / np.pi
    return cnt, tao


def test_bruteforce_matches_numpy_oracle(rng):
    hp, dep = _random_case(rng)
    cnt, tao = jax.jit(deposit_bruteforce)(hp, dep)
    wc, wt = _numpy_oracle(hp, dep)
    np.testing.assert_allclose(np.asarray(cnt), wc, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(tao), wt, rtol=2e-4, atol=1e-4)


def test_grid_chunk_invariance(rng):
    hp, dep = _random_case(rng, C=100, D=250)
    a = deposit_bruteforce(hp, dep, chunk=64)
    b = deposit_bruteforce(hp, dep, chunk=250)
    np.testing.assert_allclose(np.asarray(a[0]), np.asarray(b[0]), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(a[1]), np.asarray(b[1]),
                               rtol=2e-4, atol=1e-5)


def test_empty_deposits(rng):
    hp, dep = _random_case(rng, C=50, D=100)
    dep = dep.replace(valid=jnp.zeros_like(dep.valid))
    for fn in (deposit_bruteforce, _banded()):
        out = fn(hp, dep)
        cnt, tao = out[0], out[1]
        assert float(jnp.abs(cnt).sum()) == 0.0
        assert float(jnp.abs(tao).sum()) == 0.0


def test_compact_deposits(rng):
    from raytrace3_tpu.render.photon import compact_deposits

    hp, dep = _random_case(rng, C=80, D=300)
    # full-capacity: results identical
    c0 = deposit_bruteforce(hp, dep)
    c1 = deposit_bruteforce(hp, compact_deposits(dep, 300))
    np.testing.assert_allclose(np.asarray(c0[0]), np.asarray(c1[0]))
    # capacity >= number of valid deposits: still identical
    nvalid = int(np.asarray(dep.valid).sum())
    c2 = deposit_bruteforce(hp, compact_deposits(dep, nvalid))
    np.testing.assert_allclose(np.asarray(c0[0]), np.asarray(c2[0]), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(c0[1]), np.asarray(c2[1]),
                               rtol=2e-4, atol=1e-5)
    # tight capacity: subset (counts never exceed full)
    c3 = deposit_bruteforce(hp, compact_deposits(dep, nvalid // 2))
    assert (np.asarray(c3[0]) <= np.asarray(c0[0]) + 1e-6).all()


def _wall_case(rng, C=500, D=3000):
    """Adversarial distribution: most deposits on an x-perpendicular wall
    (x ~= 1), like the reference's left wall — breaks 1-D banding."""
    hp, dep = _random_case(rng, C=C, D=D)
    wallish = rng.uniform(size=D) < 0.6
    pos = np.asarray(dep.pos).copy()
    pos[wallish, 0] = 1.0 + rng.uniform(-0.05, 0.05, wallish.sum())
    pos[wallish, 1] = rng.uniform(0, 80, wallish.sum())
    pos[wallish, 2] = rng.uniform(0, 160, wallish.sum())
    dep = dep.replace(pos=jnp.asarray(pos))
    hpp = np.asarray(hp.pos).copy()
    wh = rng.uniform(size=C) < 0.5
    hpp[wh, 0] = 1.0
    hpp[wh, 1] = rng.uniform(0, 80, wh.sum())
    hpp[wh, 2] = rng.uniform(0, 160, wh.sum())
    hp = hp.replace(pos=jnp.asarray(hpp))
    return hp, dep


def _banded(**kw):
    """The banded Triton deposit in the Pallas interpreter."""
    from raytrace3_tpu.ops.deposit_pallas import BandedDeposit

    kw.setdefault("tile", 32)
    kw.setdefault("chunk", 64)
    return BandedDeposit(interpret=True, x_lo=-8.0, x_hi=48.0, y_lo=-8.0,
                         y_hi=88.0, **kw)


def _assert_matches_bruteforce(got, hp, dep):
    bc, bt = jax.jit(deposit_bruteforce)(hp, dep)
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(bc))
    np.testing.assert_allclose(np.asarray(got[1]), np.asarray(bt),
                               rtol=2e-4, atol=1e-4)


def test_pallas_deposit_matches_bruteforce_uniform(rng):
    hp, dep = _random_case(rng, C=400, D=900)
    _assert_matches_bruteforce(jax.jit(_banded(tile=64, chunk=128))(hp, dep),
                               hp, dep)


def test_pallas_deposit_wall_distribution(rng):
    """Adversarial wall clustering: the exact per-tile intervals adapt and
    the chunk walk has no cap, so no candidate can be dropped."""
    hp, dep = _wall_case(rng)
    _assert_matches_bruteforce(jax.jit(_banded())(hp, dep), hp, dep)


def test_pallas_deposit_prepared_layout_reuse(rng):
    """prepare() once + r2 shrink across rounds == fresh calls."""
    hp, dep = _random_case(rng, C=300, D=700)
    pd = _banded(tile=64)
    prep = pd.prepare(hp)
    for scale in (1.0, 0.7):
        hp2 = hp.replace(r2=hp.r2 * scale)
        a = pd(hp2, dep, prep=prep)
        b = pd(hp2, dep)
        _assert_matches_bruteforce(a, hp2, dep)
        np.testing.assert_allclose(np.asarray(a[0]), np.asarray(b[0]))
        np.testing.assert_allclose(np.asarray(a[1]), np.asarray(b[1]))


def test_pallas_deposit_empty_and_invalid(rng):
    hp, dep = _random_case(rng, C=100, D=200)
    pd = _banded()
    cnt, tao = pd(hp, dep.replace(valid=jnp.zeros_like(dep.valid)))
    assert float(jnp.abs(cnt).sum()) == 0.0
    assert float(jnp.abs(tao).sum()) == 0.0
    # all hit points invalid
    cnt, tao = pd(hp.replace(valid=jnp.zeros_like(hp.valid)), dep)
    assert float(jnp.abs(cnt).sum()) == 0.0


@pytest.mark.parametrize("tile,chunk", [(16, 32), (32, 16), (64, 64),
                                        (128, 32), (8, 256)])
def test_banded_tile_chunk_shapes(rng, tile, chunk):
    """Every launch shape gives the oracle's result; C = 333 and D = 777
    are multiples of neither, so the last tile and chunk are partial."""
    hp, dep = _wall_case(rng, C=333, D=777)
    _assert_matches_bruteforce(
        jax.jit(_banded(tile=tile, chunk=chunk))(hp, dep), hp, dep)


@pytest.mark.parametrize("D", [1, 31, 33, 200])
def test_banded_deposit_padding(rng, D):
    """Deposit counts below / around the lane alignment and the chunk: the
    padded rows (FAR positions) never count and no load runs off the end."""
    from raytrace3_tpu.ops.deposit_pallas import LANE_ALIGN

    hp, dep = _random_case(rng, C=120, D=D)
    pd = _banded(chunk=64)
    dkeys, rows = pd._dep_sorted(dep)
    assert rows.shape[0] == 9
    assert rows.shape[1] >= -(-D // LANE_ALIGN) * LANE_ALIGN + pd.chunk
    assert (np.asarray(rows[0:3, D:]) >= 1e8).all()
    _assert_matches_bruteforce(jax.jit(pd)(hp, dep), hp, dep)


def test_banded_wide_search_radius(rng):
    """Radii above the reference's r^2 = 2 stay exact when the bands are
    sized for them (``search_r`` = the largest radius)."""
    hp, dep = _random_case(rng, C=200, D=500)
    r2 = rng.uniform(2.0, 8.0, size=hp.capacity).astype(np.float32)
    hp = hp.replace(r2=jnp.asarray(r2))
    _assert_matches_bruteforce(jax.jit(_banded(search_r=8.0 ** 0.5))(hp, dep),
                               hp, dep)


def test_banded_layout_padding(rng):
    """Padding slots of the hit-point layout carry r2 = -1 and finite
    normals; every hit point maps to its own slot."""
    hp, dep = _random_case(rng, C=100, D=50)
    pd = _banded(tile=16)
    prep = pd.prepare(hp)
    c_pad = prep.packed.shape[1]
    assert c_pad % pd.tile == 0 and c_pad == pd._c_pad(hp.capacity)
    g = np.asarray(prep.g)
    assert len(set(g.tolist())) == hp.capacity
    pad = np.setdiff1d(np.arange(c_pad), g)
    packed = np.asarray(prep.packed)
    assert (packed[6, pad] == -1.0).all()
    assert np.isfinite(packed[3:6]).all()
    np.testing.assert_array_equal(packed[0:3, g], np.asarray(hp.pos).T)


def test_banded_kernel_direct():
    """The kernel alone on hand-made lane intervals (including empty and
    unaligned ones) against a numpy loop over the same intervals."""
    from raytrace3_tpu.ops.deposit_pallas import (K_WINDOWS,
                                                  banded_deposit_call)

    rng = np.random.default_rng(1)
    t, n_tiles, D = 16, 4, 200
    hp = rng.uniform(0, 3, size=(8, t * n_tiles)).astype(np.float32)
    hp[3:6] = 1 / np.sqrt(3)
    hp[6] = 1.0
    dep = rng.uniform(0, 3, size=(9, D + 64)).astype(np.float32)
    dep[3:6] = 1 / np.sqrt(3)
    sk = np.array([0, 10, 50, 5, 5, 60, 0, 0, 0, 100, 120, 150], np.int32)
    ek = np.array([10, 30, 90, 5, 40, 100, 0, 0, 0, 110, 140, 165], np.int32)
    out = np.asarray(banded_deposit_call(
        jnp.asarray(sk), jnp.asarray(ek), jnp.asarray(hp), jnp.asarray(dep),
        tile=t, chunk=32, num_warps=4, num_stages=2, interpret=True))
    want = np.zeros((4, t * n_tiles), np.float32)
    for i in range(n_tiles):
        lanes = np.concatenate([np.arange(sk[i * K_WINDOWS + k],
                                          ek[i * K_WINDOWS + k])
                                for k in range(K_WINDOWS)])
        for p in range(i * t, (i + 1) * t):
            d2 = ((hp[0:3, p, None] - dep[0:3, lanes]) ** 2).sum(0)
            nd = (hp[3:6, p, None] * dep[3:6, lanes]).sum(0)
            m = (d2 <= hp[6, p]) & (nd > 1e-3)
            want[0, p] = m.sum()
            want[1:, p] = dep[6:9, lanes[m]].sum(1)
    np.testing.assert_array_equal(out[0], want[0])
    np.testing.assert_allclose(out[1:], want[1:], rtol=1e-5)


def test_banded_rejects_non_power_of_two():
    from raytrace3_tpu.ops.deposit_pallas import BandedDeposit

    with pytest.raises(ValueError, match="power of two"):
        BandedDeposit(tile=48)
    with pytest.raises(ValueError, match="power of two"):
        BandedDeposit(chunk=100)


def test_banded_lowers_for_cuda(rng):
    """The kernel lowers to a Triton call for the GPU (power-of-two block
    shapes, supported primitives) without a card: only the PTX compile
    needs one."""
    hp, dep = _random_case(rng, C=1000, D=3000)
    pd = _banded(tile=64, chunk=64)
    pd.interpret = False
    text = jax.jit(pd).trace(hp, dep).lower(
        lowering_platforms=("cuda",)).as_text()
    assert "__gpu$xla.gpu.triton" in text


@pytest.mark.gpu
def test_banded_compiled_matches_bruteforce_on_gpu(gpu, rng):
    """The compiled kernel on the card against the oracle."""
    from raytrace3_tpu.ops.deposit_pallas import BandedDeposit

    hp, dep = _wall_case(rng, C=5000, D=20000)
    pd = BandedDeposit(x_lo=-8.0, x_hi=48.0, y_lo=-8.0, y_hi=88.0)
    with jax.default_matmul_precision("highest"):
        _assert_matches_bruteforce(jax.jit(pd)(hp, dep), hp, dep)


def test_packed_rounds_state_matches_hp_space(rng):
    """photon_rounds' LAYOUT-SPACE fast path (pack_state / packed_call /
    unpack once per pass) must reproduce the per-round hp-space path bit
    for bit: same kernel, same update math, only the order/space of the
    elementwise PPM update changes."""
    from raytrace3_tpu.render.sppm import photon_rounds
    from raytrace3_tpu.render.driver import build_scene
    from raytrace3_tpu.utils.config import RenderConfig

    cfg = RenderConfig(scene="cornell_diffuse", width=16, height=16,
                       rounds=3, photons_per_round=1024, max_depth=4,
                       atlas_res=16)
    scene = build_scene(cfg)
    from raytrace3_tpu.render.camera import emit_rays, look_at
    from raytrace3_tpu.render.eye import eye_pass

    cam = look_at(jnp.asarray([50.0, 35.0, 230.0]),
                  jnp.asarray([50.0, 35.042612, 229.0]), 16, 16)
    org, dirs = emit_rays(cam)
    hp, _ = eye_pass(scene, org, dirs, 512, cfg.max_depth)

    from raytrace3_tpu.ops.deposit_pallas import BandedDeposit

    depo = BandedDeposit(tile=128, chunk=256, x_lo=-4.0, x_hi=104.0,
                         interpret=True)
    key = jax.random.key(5)
    run = lambda: photon_rounds(scene, key, hp, cfg.rounds,
                                cfg.photons_per_round, cfg.max_depth,
                                deposit_fn=depo)
    hp_packed, em_p, dr_p = jax.jit(run)()

    # Force the hp-space path by hiding packed_call behind a plain wrapper.
    class HpSpace:
        prepare = depo.prepare

        def __call__(self, h, d, prep=None):
            return depo(h, d, prep=prep)

    hp_ref, em_r, dr_r = jax.jit(
        lambda: photon_rounds(scene, key, hp, cfg.rounds,
                              cfg.photons_per_round, cfg.max_depth,
                              deposit_fn=HpSpace()))()
    assert float(em_p) == float(em_r)
    assert int(dr_p) == int(dr_r)
    np.testing.assert_allclose(np.asarray(hp_packed.r2),
                               np.asarray(hp_ref.r2), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(hp_packed.tao),
                               np.asarray(hp_ref.tao), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(np.asarray(hp_packed.nphot),
                               np.asarray(hp_ref.nphot), rtol=1e-6)


def test_epanechnikov_deposit_gradients_match_fd(rng):
    """The smooth-kernel deposit (round 5, VERDICT item 4): its flux weight
    2(1-d2/r2) is continuous at the radius boundary, so plain-AD gradients
    w.r.t. deposit positions, hit positions AND r2 must match central FD —
    exactly the property the box kernel lacks (boundary term).  Also checks
    the kernel integrates like the box: summed flux over a dense uniform
    disc of deposits ~ equals the box kernel's (same density estimate)."""
    from raytrace3_tpu.render.deposit import (deposit_bruteforce,
                                              deposit_bruteforce_epa)

    hp, dep = _random_case(rng, C=60, D=200)
    # densify: _random_case's 40^3 box yields ~1 neighbour pair at r ~ 1.4;
    # shrink to 10^3 so the gradient has real support
    hp = hp.replace(pos=hp.pos / 4.0)
    dep = dep.replace(pos=dep.pos / 4.0)

    def loss(dpos, hpos, r2):
        h = hp.replace(pos=hpos, r2=r2)
        d = dep.replace(pos=dpos)
        cnt, tao = deposit_bruteforce_epa(h, d, chunk=128)
        # weighted sum -> sensitive to every coordinate
        w = jnp.arange(tao.size, dtype=jnp.float32).reshape(tao.shape)
        return jnp.sum(tao * (0.5 + 0.01 * w))

    g_dp, g_hp, g_r2 = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
        dep.pos, hp.pos, hp.r2)
    f = jax.jit(loss)
    eps = 3e-3
    rng2 = np.random.default_rng(1)
    checked = 0
    for arr, g, name in ((dep.pos, g_dp, "dpos"), (hp.pos, g_hp, "hpos"),
                         (hp.r2, g_r2, "r2")):
        a = np.asarray(arr)
        ga = np.asarray(g)
        nz = np.flatnonzero(np.abs(ga).ravel() > 1e-4)
        if nz.size == 0:
            continue
        for flat in rng2.choice(nz, size=min(6, nz.size), replace=False):
            idx = np.unravel_index(int(flat), a.shape)
            def at(v):
                b = a.copy(); b[idx] = v
                args = {"dpos": (jnp.asarray(b), hp.pos, hp.r2),
                        "hpos": (dep.pos, jnp.asarray(b), hp.r2),
                        "r2": (dep.pos, hp.pos, jnp.asarray(b))}[name]
                return float(f(*args))
            fd = (at(a[idx] + eps) - at(a[idx] - eps)) / (2 * eps)
            ad = float(ga[idx])
            assert abs(fd - ad) <= 0.08 * max(abs(fd), abs(ad)) + 1e-3, (
                name, idx, fd, ad)
            checked += 1
    assert checked >= 10, checked

    # normalisation sanity: dense uniform deposits on one hit point's disc
    # -> epa and box flux sums agree to a few percent (both estimate the
    # same density: epa weight integrates to 1 over the disc)
    C1 = make_hitpoints(1, init_r2=2.0)
    C1 = C1.replace(pos=jnp.zeros((1, 3)), n=jnp.asarray([[0.0, 1.0, 0.0]]),
                    wgt=jnp.ones((1, 3)), valid=jnp.ones((1,), bool))
    M = 60000
    xy = rng.uniform(-1.5, 1.5, size=(M, 2)).astype(np.float32)
    dpos = np.stack([xy[:, 0], np.zeros(M, np.float32), xy[:, 1]], 1)
    dd = Deposits(pos=jnp.asarray(dpos),
                  n=jnp.broadcast_to(jnp.asarray([0.0, 1.0, 0.0]), (M, 3)),
                  flux=jnp.ones((M, 3)), valid=jnp.ones((M,), bool))
    _, tao_box = deposit_bruteforce(C1, dd)
    _, tao_epa = deposit_bruteforce_epa(C1, dd)
    ratio = float(tao_epa[0, 0] / tao_box[0, 0])
    assert abs(ratio - 1.0) < 0.05, ratio
