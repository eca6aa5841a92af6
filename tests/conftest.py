"""Test configuration: run JAX on a virtual 8-device CPU mesh.

Tests run on the host CPU with 8 virtual devices whatever accelerator the
machine has: the platform is set through jax.config before any backend
initialization, and XLA_FLAGS before jax is imported.  Tests that need a
GPU carry the ``gpu`` marker and take the ``gpu_device`` fixture, which
skips them here; ``python chip_smoke.py`` runs the same checks on the card.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from vfp_tpu.utils import enable_compile_cache  # noqa: E402

enable_compile_cache()

import numpy as np  # noqa: E402
import pytest  # noqa: E402

assert jax.devices()[0].platform == "cpu", jax.devices()


@pytest.fixture
def rng():
    return np.random.RandomState(1234)


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip.  Decided here, at test time, never while
    modules are imported: pytest-xdist workers must all collect the same
    tests.  This suite pins JAX to the CPU, so GPU tests skip under it and
    run on the card through chip_smoke.py."""
    try:
        gpus = jax.devices("gpu")
    except RuntimeError:
        gpus = []
    if not gpus:
        pytest.skip("needs an NVIDIA GPU; run python chip_smoke.py on the card")
    return gpus[0]
