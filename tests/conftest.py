"""Test harness.

By default the tests run on the CPU with 8 virtual devices, so the
sharding tests work without a GPU: set `JAX_PLATFORMS=cpu` (the harness
does so when nothing else is set). Tests marked `gpu` need an NVIDIA GPU;
they skip with a reason elsewhere, and on a card they run with

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/

Whether a card is present is decided inside the `gpu_device` fixture, never
while modules are collected, so every xdist worker collects the same tests.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
if os.environ["JAX_PLATFORMS"] == "cpu":
    os.environ.setdefault(
        "XLA_FLAGS", "--xla_force_host_platform_device_count=8"
    )

import jax  # noqa: E402
import pytest  # noqa: E402

import tcnn_tpu  # noqa: E402

tcnn_tpu.enable_compilation_cache()


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test when JAX has none."""
    devices = jax.devices()
    if devices[0].platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU; JAX runs on {devices[0].platform}")
    return devices[0]
