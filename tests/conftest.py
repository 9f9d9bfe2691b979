"""Test harness configuration.

By default tests run on the CPU backend with 8 virtual devices, so the
multi-device sharding logic is exercised without a GPU mesh (SURVEY.md
§4.5), and with x64 enabled so the reference's float64 epsilon ladder is
meaningful.

Set GJKEPA_GPU_TESTS=1 to run on the GPU instead: the CPU forcing and x64
are skipped, and the tests marked `gpu` run.  Whether a GPU is present is
decided inside the `gpu_device` fixture, so every worker collects the same
tests; without a GPU those tests skip.
"""

import os

_GPU_MODE = os.environ.get("GJKEPA_GPU_TESTS", "") not in ("", "0")

if not _GPU_MODE:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

if not _GPU_MODE:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test where JAX has none."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        pytest.skip("needs a GPU: run with GJKEPA_GPU_TESTS=1 on a machine "
                    "with one")
    return devs[0]


def random_hull(rng, n=16, center=(0, 0, 0), scale=1.0):
    """Random convex position cloud: points on a sphere scaled/offset.

    Every vertex is extreme (on the sphere), so the cloud is its own hull.
    """
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    v *= scale * (0.5 + 0.5 * rng.random((n, 1)))
    return v + np.asarray(center, dtype=np.float64)


def cube(center=(0, 0, 0), half=0.5):
    c = np.asarray(center, dtype=np.float64)
    corners = np.array(
        [[x, y, z] for x in (-half, half) for y in (-half, half) for z in (-half, half)]
    )
    return c + corners


def pytest_configure(config):
    # One JAX process per card: each reserves most of the card's memory, so
    # xdist workers (the -n 4 default in pyproject) would fail for want of
    # it.  xdist starts its workers before a conftest hook can stop them,
    # so fail fast with the right invocation.
    if _GPU_MODE and os.environ.get("PYTEST_XDIST_WORKER"):
        raise pytest.UsageError(
            "GJKEPA_GPU_TESTS=1 must run in one process: add '-n 0'")
