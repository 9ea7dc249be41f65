"""Backend selection, entry-point plumbing and the dependency-free helpers:
the compile-cache helper, the PNG writer, the pytree dataclasses, the
trace reducer, and a CLI run with flax and PIL unavailable."""

import os
import struct
import subprocess
import sys
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytrace3_tpu.backends import select_backends
from raytrace3_tpu.render.deposit import deposit_bruteforce
from raytrace3_tpu.render.driver import build_scene
from raytrace3_tpu.utils.config import PRESETS, RenderConfig, get_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = RenderConfig(scene="full", width=32, height=32, atlas_res=8)


@pytest.fixture(scope="module")
def scene():
    return build_scene(CFG)


def test_gpu_selects_compiled_banded_kernel(scene):
    from raytrace3_tpu.ops.deposit_pallas import BandedDeposit

    # a default RenderConfig, as cli and __graft_entry__.entry() build it
    dep, newton = select_backends(RenderConfig(), scene, "gpu")
    assert isinstance(dep, BandedDeposit)
    assert dep.interpret is False
    # world bounds come from the scene geometry plus the camera
    assert dep.x_lo < 1.0 and dep.x_lo + dep.n_buckets * dep.bucket > 99.0
    assert newton.keywords == {"iters": CFG.newton_iters,
                               "restarts": CFG.newton_restarts}


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_every_preset_gets_the_banded_kernel_on_gpu(scene, preset):
    from raytrace3_tpu.ops.deposit_pallas import BandedDeposit

    dep, _ = select_backends(get_config(preset), scene, "gpu")
    assert isinstance(dep, BandedDeposit) and dep.interpret is False


@pytest.mark.parametrize("init_r2", [0.5, 2.0, 8.0])
def test_banded_bands_cover_the_initial_radius(scene, init_r2):
    dep, _ = select_backends(CFG.replace(init_r2=init_r2), scene, "gpu")
    assert dep.search_r == pytest.approx(init_r2 ** 0.5)
    assert dep.bucket == pytest.approx(2.0 * init_r2 ** 0.5)


@pytest.mark.parametrize("platform", ["cpu", "gpu"])
def test_plain_xla_backends(scene, platform):
    """The plain-XLA all-pairs deposit is the CPU's backend for every
    preset, and never the GPU's."""
    for name in PRESETS:
        dep, _ = select_backends(get_config(name), scene, platform)
        assert (dep is deposit_bruteforce) == (platform == "cpu"), name


def test_cpu_refuses_banded(scene):
    # even the presets tuned for the card get the plain-XLA deposit on the
    # CPU: the Triton kernel has no CPU lowering
    dep, _ = select_backends(get_config("bench512"), scene, "cpu")
    assert dep is deposit_bruteforce


@pytest.mark.parametrize("platform", ["rocm", "metal", "neuron"])
def test_unknown_platform_raises(scene, platform):
    with pytest.raises(ValueError, match="unsupported platform"):
        select_backends(CFG, scene, platform)


def test_unknown_deposit_raises():
    # the platform picks the deposit; a config cannot name one
    with pytest.raises(TypeError):
        CFG.replace(deposit="grid")


def test_differentiable_selects_bruteforce_vjp(scene):
    """The training step's deposit (the all-pairs custom VJP) computes the
    same forward as the CPU's render deposit."""
    from raytrace3_tpu.core.types import Deposits, make_hitpoints
    from raytrace3_tpu.diff.vjp import deposit_bruteforce_vjp

    dep_fn, _ = select_backends(CFG, scene, "cpu")
    rng = np.random.default_rng(0)
    C, D = 40, 96
    n = rng.normal(size=(C, 3)).astype(np.float32)
    hp = make_hitpoints(C, 2.0, jnp.float32).replace(
        pos=jnp.asarray(rng.uniform(0, 4, (C, 3)), jnp.float32),
        n=jnp.asarray(n / np.linalg.norm(n, axis=-1, keepdims=True)),
        wgt=jnp.ones((C, 3), jnp.float32),
        valid=jnp.asarray(rng.uniform(size=C) < 0.8))
    dep = Deposits(
        pos=jnp.asarray(rng.uniform(0, 4, (D, 3)), jnp.float32),
        n=jnp.tile(hp.n[:1], (D, 1)),
        flux=jnp.asarray(rng.uniform(0, 1, (D, 3)), jnp.float32),
        valid=jnp.asarray(rng.uniform(size=D) < 0.9))
    want = dep_fn(hp, dep)
    got = deposit_bruteforce_vjp(hp, dep)
    assert float(want[0].sum()) > 0
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(want[0]))
    np.testing.assert_allclose(np.asarray(got[1]), np.asarray(want[1]),
                               rtol=1e-5, atol=1e-6)


def test_default_platform_is_the_first_device(scene):
    # the test session runs on the CPU: the default is "cpu", which gets
    # the plain-XLA deposit
    assert jax.devices()[0].platform == "cpu"
    dep, _ = select_backends(CFG, scene)
    assert dep is deposit_bruteforce


def test_bench512_preset():
    cfg = get_config("bench512")
    assert (cfg.width, cfg.height, cfg.rounds, cfg.photons_per_round) == (
        512, 512, 16, 131072)
    assert cfg.newton_restarts == 8
    assert cfg.photon_regen and cfg.eye_compact_schedule


def test_compile_cache_uses_env_dir(monkeypatch, tmp_path):
    from raytrace3_tpu.utils.cache import enable_compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before   # nothing set


def test_compile_cache_defaults_to_repo_dir(monkeypatch):
    from raytrace3_tpu.utils.cache import REPO_CACHE_DIR, enable_compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        assert enable_compile_cache() == REPO_CACHE_DIR
        assert jax.config.jax_compilation_cache_dir == REPO_CACHE_DIR
        assert REPO_CACHE_DIR == os.path.join(REPO, ".jax_cache")
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def _decode_png(data: bytes) -> np.ndarray:
    """Minimal 8-bit RGB, filter-0 PNG decoder (what encode_png writes)."""
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, w, h = 8, b"", None, None
    while pos < len(data):
        n, = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        crc, = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        assert crc == zlib.crc32(tag + body) & 0xFFFFFFFF
        if tag == b"IHDR":
            w, h, depth, ctype = struct.unpack(">IIBB", body[:10])
            assert (depth, ctype) == (8, 2)
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    assert (raw[:, 0] == 0).all()
    return raw[:, 1:].reshape(h, w, 3)


def test_png_round_trip(tmp_path):
    from raytrace3_tpu.utils.image import save_png, to_uint8

    rng = np.random.default_rng(0)
    img8 = rng.integers(0, 256, (5, 7, 3)).astype(np.uint8)
    p = tmp_path / "a.png"
    save_png(str(p), img8, tonemapped=True)
    np.testing.assert_array_equal(_decode_png(p.read_bytes()), img8[::-1])
    radiance = rng.uniform(0, 3, (4, 6, 3))
    save_png(str(p), radiance)
    np.testing.assert_array_equal(_decode_png(p.read_bytes()),
                                  to_uint8(radiance)[::-1])


def test_pytree_dataclass_replace_and_static_fields():
    from raytrace3_tpu.core.pytree import pytree_dataclass, static_field

    @pytree_dataclass
    class Thing:
        a: jnp.ndarray
        b: jnp.ndarray | None
        n: int = static_field(default=3)

    t = Thing(a=jnp.ones(2), b=None)
    leaves, tdef = jax.tree.flatten(t)
    assert len(leaves) == 1                      # None and n are not leaves
    t2 = jax.tree.map(lambda x: x * 2, t)
    assert t2.n == 3 and t2.b is None
    np.testing.assert_array_equal(t2.a, [2.0, 2.0])
    t3 = t.replace(n=5)
    assert t3.n == 5 and t.n == 3                # frozen, copied
    with pytest.raises(AttributeError):
        t.n = 4

    @jax.jit
    def f(x):
        return x.a * x.n                         # n stays a Python int

    np.testing.assert_array_equal(f(t3), [5.0, 5.0])
    assert jax.tree.structure(t) != jax.tree.structure(t3)


def test_scene_static_fields_survive_jit(scene):
    s2 = scene.replace(newton_restarts=16)
    out = jax.jit(lambda s: s.newton_restarts * s.light_pos)(s2)
    np.testing.assert_allclose(out, 16 * s2.light_pos)


def test_trace_reducer_attributes_named_scopes(tmp_path):
    from raytrace3_tpu.utils.trace import busy_ns, latest_xplane, scope_times

    @jax.jit
    def f(x):
        with jax.named_scope("newton"):
            y = jnp.sin(x) @ x
        with jax.named_scope("deposit"):
            z = jnp.sort(y.ravel())
        return z

    x = jnp.ones((128, 128))
    compiled = f.lower(x).compile()
    jax.block_until_ready(compiled(x))
    jax.profiler.start_trace(str(tmp_path))
    jax.block_until_ready(compiled(x))
    jax.profiler.stop_trace()
    rec = scope_times(latest_xplane(str(tmp_path)), compiled.as_text(),
                      ("newton", "deposit", "absent"),
                      plane_prefix="/host:CPU")
    assert rec["events"] > 0
    assert rec["scope_ms"]["newton"] > 0 and rec["scope_ms"]["deposit"] > 0
    assert rec["scope_ms"]["absent"] == 0
    assert busy_ns([(0, 10), (5, 10), (30, 5)]) == 20


def test_cli_runs_without_flax_and_pil(tmp_path):
    """The main path imports neither flax nor PIL: a CLI render succeeds
    with both blocked in sys.modules and writes a valid PNG."""
    out = tmp_path / "r.png"
    code = (
        "import sys; sys.modules['flax'] = None; sys.modules['PIL'] = None\n"
        "from raytrace3_tpu.cli import main\n"
        f"raise SystemExit(main(['--platform', 'cpu', '--scene', "
        f"'cornell_diffuse', '--res', '8', '--passes', '1', '--rounds', "
        f"'1', '--photons', '128', '--depth', '2', '--out', {str(out)!r}]))"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=str(tmp_path / "cache"))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert _decode_png(out.read_bytes()).shape == (8, 8, 3)


def test_grid_window_counts_the_fullest_cell():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "deposit_sweep", os.path.join(REPO, "scripts", "deposit_sweep.py"))
    sweep = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sweep)
    pos = np.array([[0.1, 0.1, 0.1], [0.2, 0.3, 0.4], [5.0, 5.0, 5.0],
                    [0.5, 0.5, 0.5], [-3.0, 0.5, 0.5]], np.float32)
    valid = np.array([True, True, True, False, True])
    rec = sweep.grid_window(10, pos, valid, cell=1.0, lo=(0, 0, 0),
                            hi=(10, 10, 10))
    # the out-of-box deposit clamps into the first cell with the other two
    assert rec["cells"] == 1000 and rec["max_cell_occupancy"] == 3
    assert rec["gather_bytes"] == 10 * 3 * 3 * 4
    # bench512's round: 340 787 hit points, 65 709 deposits in one cell;
    # the grid's allocation that failed on the card was 250.27 GiB
    dense = np.full((65709, 3), 50.0, np.float32)
    rec = sweep.grid_window(340787, dense, np.ones(65709, bool),
                            cell=2.0 ** 0.5)
    assert rec["gather_bytes"] / 2 ** 30 == pytest.approx(250.27, rel=1e-4)
