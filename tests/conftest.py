"""Test configuration: CPU backend with an 8-device virtual mesh.

The standard JAX trick for testing multi-device sharding without a cluster
(SURVEY.md section 4): force the host platform and split it into 8 virtual
devices.  Must run before the first JAX backend initialisation, hence the
env mutation at import time.

Tests marked ``gpu`` need the card and skip elsewhere (decided in the
``gpu`` fixture, never at collection).  To run them on a GPU host, keep
JAX's default platform:  RT3_TEST_GPU=1 python -m pytest tests -m gpu
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

import jax

if os.environ.get("RT3_TEST_GPU") != "1":
    jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def key():
    return jax.random.key(0)


@pytest.fixture
def gpu():
    """The first device, if it is a GPU; skips the test otherwise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (RT3_TEST_GPU=1 on a GPU host); "
                    f"have {dev.platform}")
    return dev
