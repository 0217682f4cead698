"""Persistent XLA compilation cache: the one place that sets it.

A cold process compiles every jitted step (tens of seconds for a training
step with fused kernels); JAX's persistent compilation cache keeps the
compiled programs across processes. Scripts, benchmarks and the test
harness call `enable_compilation_cache()` and set no cache of their own:

    import tcnn_tpu as tc
    tc.enable_compilation_cache()

The directory is `$JAX_COMPILATION_CACHE_DIR` when that is set (JAX reads
it itself, and no other directory is set), else `.jax_cache` at the root
of the checkout this package lives in.
"""

from __future__ import annotations

import os

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"


def cache_dir() -> str:
    """The directory `enable_compilation_cache` uses."""
    if os.environ.get(ENV_VAR):
        return os.environ[ENV_VAR]
    checkout = os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )
    return os.path.join(checkout, ".jax_cache")


def enable_compilation_cache() -> str:
    """Turn on JAX's persistent compilation cache for this process and
    return its directory. Compiles faster than 2 s are not persisted
    (cheaper to redo than to read back)."""
    path = cache_dir()
    if not os.environ.get(ENV_VAR):
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)
    return path
