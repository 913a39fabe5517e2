"""Test configuration: force the CPU backend with 8 virtual devices so
multi-device sharding paths are exercised without several cards.

Tests that need a GPU carry the `gpu` marker and take the `gpu_device`
fixture, which skips them on this forced-CPU suite; chip_smoke.py runs
the same checks on the card.
"""
import os

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a GPU; skipped on the CPU, covered on the "
                   "card by chip_smoke.py")


@pytest.fixture
def gpu_device():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (JAX runs on {dev.platform}); "
                    "chip_smoke.py covers this on the card")
    return dev
