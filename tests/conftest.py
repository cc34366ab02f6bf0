"""Test environment: force a CPU backend with 8 virtual devices.

Must run before jax computes anything.  Tests run on host CPU so they are
parallel-safe and can build an 8-device mesh for sharding tests (SURVEY.md
§4: multi-host tests on a single host via
``--xla_force_host_platform_device_count``).
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
# CLI entry points turn on the persistent compilation cache
# (utils/cache.py); tests keep every compile in process.
os.environ["JAX_ENABLE_COMPILATION_CACHE"] = "false"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

# jax may already be imported before pytest starts, so the env vars above
# may be too late for jax.config; force the platform explicitly (backends
# initialize lazily — this works as long as no computation ran).
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_compilation_cache", False)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

assert jax.devices()[0].platform == "cpu", "tests must run on host CPU"


@pytest.fixture()
def rng():
    # Function-scoped on purpose: a session-scoped stream makes every
    # rng-using test depend on which tests ran before it (adding a test
    # anywhere reshuffles everyone's draws — an order-dependent suite).
    return np.random.default_rng(0)
