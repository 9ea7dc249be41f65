"""Backend selection: the one place that maps (config, device platform) to
the deposit and Newton implementations a render uses.

Every entry point (cli, bench.py, chip_smoke.py, ``__graft_entry__`` and
the scripts) calls :func:`select_backends`.  The platform decides:

  * ``gpu``: the banded deposit, a Triton kernel compiled for the card
    (``ops/deposit_pallas.py``);
  * ``cpu``: the plain-XLA all-pairs deposit (``render/deposit.py``).  The
    CPU is for tests and small renders and is always chosen explicitly;
  * anything else raises.

Newton is the jnp solver (``geometry/bezier.py``) on every platform: XLA
fuses its elementwise iteration.  The training step does not come through
here: its deposit is the all-pairs custom VJP (``diff/vjp.py``), exact on
every platform.
"""

from __future__ import annotations

import math
from functools import partial

import jax

from .geometry.bezier import solve_winner
from .utils.config import RenderConfig

#: Reference camera position (main.cpp:24); bounds where eye hits can land.
CAM_POS = (50.0, 35.0, 230.0)
PLATFORMS = ("gpu", "cpu")


def device_platform() -> str:
    """Platform of the first JAX device (``gpu`` on a CUDA card)."""
    return jax.devices()[0].platform


def select_backends(cfg: RenderConfig, scene, platform: str | None = None):
    """(deposit_fn, newton_fn) for ``cfg`` on ``platform``.

    ``platform`` defaults to :func:`device_platform`.  ``scene`` supplies the
    world bounds of the banded deposit.
    """
    platform = platform or device_platform()
    if platform not in PLATFORMS:
        raise ValueError(
            f"unsupported platform {platform!r}: the renderer runs on "
            f"{' or '.join(PLATFORMS)}")
    newton_fn = partial(solve_winner, iters=cfg.newton_iters,
                        restarts=cfg.newton_restarts)
    if platform == "cpu":
        from .render.deposit import deposit_bruteforce
        return deposit_bruteforce, newton_fn

    from .ops.deposit_pallas import BandedDeposit, world_bounds_from_scene
    b = world_bounds_from_scene(scene, extra_points=[list(CAM_POS)])
    # the bands are 2r wide: r must bound every hit point's radius
    return BandedDeposit(search_r=math.sqrt(cfg.init_r2), x_lo=b["x_lo"],
                         x_hi=b["x_hi"], y_lo=b["y_lo"],
                         y_hi=b["y_hi"]), newton_fn
