"""Device reporting (tcnn_tpu/utils/device.py) and the compilation-cache
directory rule (tcnn_tpu/utils/compile_cache.py)."""

import os

import jax
import pytest

from tcnn_tpu.utils import compile_cache
from tcnn_tpu.utils.device import (
    NoGpuError,
    device_info,
    parse_nvidia_smi,
    require_gpu,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize(
    "text,cards",
    [
        ("NVIDIA H200, 700.00 W",
         [{"name": "NVIDIA H200", "power_limit_w": 700.0}]),
        ("NVIDIA H200, 700.00 W\nNVIDIA H200, 500.00 W\n",
         [{"name": "NVIDIA H200", "power_limit_w": 700.0},
          {"name": "NVIDIA H200", "power_limit_w": 500.0}]),
        ("NVIDIA H100 80GB HBM3, [N/A]",
         [{"name": "NVIDIA H100 80GB HBM3", "power_limit_w": None}]),
        ("Some, Card, 350 W", [{"name": "Some, Card", "power_limit_w": 350.0}]),
    ],
)
def test_parse_nvidia_smi(text, cards):
    assert parse_nvidia_smi(text) == cards


def test_parse_nvidia_smi_rejects_garbage():
    with pytest.raises(ValueError):
        parse_nvidia_smi("no comma here")


def test_require_gpu_refuses_this_host():
    if jax.devices()[0].platform == "gpu":
        pytest.skip("this host has a GPU")
    with pytest.raises(NoGpuError, match="needs an NVIDIA GPU"):
        require_gpu()


def test_device_info_reports_jax_and_card():
    info = device_info("NVIDIA H200, 700.00 W")
    dev = jax.devices()[0]
    assert info == {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices()), "card": "NVIDIA H200",
        "power_limit_w": 700.0,
    }


def test_cache_dir_defaults_to_checkout(monkeypatch):
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    assert compile_cache.cache_dir() == os.path.join(REPO, ".jax_cache")


def test_cache_dir_follows_environment(monkeypatch, tmp_path):
    monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path))
    assert compile_cache.cache_dir() == str(tmp_path)


def test_enable_sets_checkout_cache(monkeypatch):
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    path = compile_cache.enable_compilation_cache()
    assert path == os.path.join(REPO, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    assert os.path.isdir(path)


def test_enable_sets_no_directory_when_environment_does(monkeypatch, tmp_path):
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    before = compile_cache.enable_compilation_cache()
    monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path / "c"))
    assert compile_cache.enable_compilation_cache() == str(tmp_path / "c")
    # the environment variable is JAX's own; no other directory was set
    assert jax.config.jax_compilation_cache_dir == before
    assert not (tmp_path / "c").exists()


def test_device_time_reduces_a_trace(tmp_path):
    """utils/profiling.device_time on a small recorded trace: the busy time
    is the union of event intervals (never more than the window) and the
    traced program's matrix product shows up with its duration."""
    import jax.numpy as jnp

    from tcnn_tpu.utils.profiling import device_time, trace

    f = jax.jit(lambda x: jnp.sin(x) @ x)
    x = jnp.ones((128, 128))
    f(x).block_until_ready()
    with trace(str(tmp_path)):
        for _ in range(3):
            y = f(x)
        y.block_until_ready()
    # the CPU backend records its ops on the host plane
    r = device_time(str(tmp_path), device_prefix="/host:CPU")
    assert 0 < r["busy_ns"] <= r["window_ns"]
    assert 0.0 <= r["idle_share"] < 1.0
    assert any("dot" in name and ns > 0 for name, ns in r["kernels_ns"].items())
    assert all(ns >= 0 for ns in r["kernels_ns"].values())
    with pytest.raises(ValueError, match="no /device:GPU:"):
        device_time(str(tmp_path))
