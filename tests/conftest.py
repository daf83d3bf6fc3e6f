"""Test configuration: run JAX on a virtual 8-device CPU mesh with x64.

Mirrors the distributed test strategy in SURVEY §4: sharded results must
match unsharded ones without accelerator hardware. Run as the README says,
with ``JAX_PLATFORMS=cpu``; the platform is also pinned here before the
first backend use, so a plain ``pytest`` never touches an accelerator.
"""

import os

# must precede CPU backend initialization
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
assert jax.devices()[0].platform == "cpu"
assert len(jax.devices()) == 8

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from mpassit_jax.mesh.synthetic import synthetic_voronoi_mesh  # noqa: E402


@pytest.fixture(scope="session")
def small_mesh():
    return synthetic_voronoi_mesh(ncells=600, nz=4, nsoil=2, seed=3)


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(12345)
