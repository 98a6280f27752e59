"""Test configuration: run JAX on a virtual 8-device CPU mesh.

Must set env vars before the first ``import jax`` anywhere in the test
process, so this sits at the top of conftest.  ``JAX_PLATFORMS`` defaults
to the CPU; the ``gpu``-marked tests run on a card with
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    flags += " --xla_force_host_platform_device_count=8"
if "collective_call_terminate_timeout" not in flags:
    # 8 virtual devices time-slice one core: a replica can take longer
    # than the default 20 s/40 s collective-rendezvous timeouts to reach
    # its ppermute, which ABORTS the process (flaky under load)
    flags += (" --xla_cpu_collective_call_warn_stuck_timeout_seconds=300"
              " --xla_cpu_collective_call_terminate_timeout_seconds=1200")
os.environ["XLA_FLAGS"] = flags.strip()

import jax  # noqa: E402  (after the env set-up above)

from ebcc_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

# persistent compilation cache: the full pipeline compiles in 40-90 s per
# geometry on a small CPU host; cached executables cut suite re-runs by
# many minutes.  Programs are keyed by their HLO, so results are unaffected.
enable_compile_cache()

import numpy as np
import pytest


@pytest.fixture(scope="session")
def era5_frame():
    """The reference's canonical test fixture: 721x1440 f32 temperature."""
    path = "/root/reference/data/test_data.npy"
    if os.path.exists(path):
        return np.load(path).astype(np.float32)
    rng = np.random.default_rng(0)
    # synthetic smooth field with the same shape/scale as ERA5 temperature
    y, x = np.mgrid[0:721, 0:1440]
    base = 260 + 25 * np.sin(y / 721 * np.pi) * np.cos(x / 1440 * 2 * np.pi)
    return (base + rng.normal(0, 0.5, base.shape)).astype(np.float32)


@pytest.fixture(scope="session")
def small_frame(era5_frame):
    """Small crop for fast unit tests."""
    return np.ascontiguousarray(era5_frame[:96, :160])


@pytest.fixture
def gpu():
    """The first GPU, or a skip: tests that need the card decide here,
    never at import time."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (JAX platform is {dev.platform!r}); "
                    "chip_smoke.py covers this path on the card")
    return dev
