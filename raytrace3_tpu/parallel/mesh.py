"""Device-mesh construction for the renderer's parallel axes.

Reference: the only parallelism is a 4-thread OpenMP loop over SPPM passes
with a serial canvas merge (raytracer/Raytracer.h:442-458; SURVEY.md section
2 "Parallelism strategies").  The mesh axes (SURVEY.md maps them
explicitly):

  * ``pass``   — independent jittered SPPM passes (the OpenMP loop's role):
                 pure data parallelism, cheap across hosts.
  * ``photon`` — photons and eye rays sharded WITHIN a pass; deposits are
                 psum'd, hit points all-gathered.

``jax.distributed.initialize`` + the standard mesh utils handle multi-host;
nothing here hand-writes communication — XLA inserts the collectives (NCCL
between GPUs) from the sharding specs alone.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, PartitionSpec as P  # noqa: F401 (re-export)

PASS_AXIS = "pass"
PHOTON_AXIS = "photon"


def make_mesh(n_pass: int | None = None, n_photon: int | None = None,
              devices=None) -> Mesh:
    """Build a (pass, photon) mesh over the given (default: all) devices.

    With only one count given, the other absorbs the remaining devices.
    Defaults put every device on the photon axis (strong scaling of a single
    pass); pass-parallelism is the cheap axis to grow for throughput.
    """
    devices = np.asarray(devices if devices is not None else jax.devices())
    n = devices.size
    if n_pass is None and n_photon is None:
        n_pass, n_photon = 1, n
    elif n_pass is None:
        n_pass = n // n_photon
    elif n_photon is None:
        n_photon = n // n_pass
    if n_pass * n_photon != n:
        raise ValueError(
            f"mesh {n_pass}x{n_photon} != {n} devices"
        )
    return Mesh(devices.reshape(n_pass, n_photon), (PASS_AXIS, PHOTON_AXIS))


def multihost_init(coordinator: str | None = None, num_processes: int | None = None,
                   process_id: int | None = None) -> None:
    """Initialise multi-host JAX (no-op when single-process).

    The reference has no distributed backend at all; this is the standard
    ``jax.distributed`` bootstrap — collectives then span hosts via DCN with
    zero further code changes.
    """
    if num_processes is not None and num_processes > 1:
        jax.distributed.initialize(coordinator, num_processes, process_id)
