#!/usr/bin/env python
"""Benchmark: mlp_learning_an_image throughput (config_hash) on one GPU.

The reference headline: RTX 4090 trains the default config (HashGrid
L16/F2/T2^15/base16/s1.5 + FFMLP 64x2, RelativeL2, Adam, batch 2^18) at
~1000 steps/s = ~2.62e8 trained samples/s (README.md:75, BASELINE.md).

This benchmark mirrors the reference protocol (bench_ours.cu:188-332):
random-uniform coordinate batches sampled from an image each step, mean
training throughput after warmup. Batch generation, bilinear image sampling
and the full training step run inside one jitted program of SCAN_STEPS
steps, the analog of the reference's CUDA-graph-captured step. Inference is
timed the same way: a jitted loop whose iterations chain (each input
depends on the previous output). Every timed window ends in
`block_until_ready`.

It exits non-zero, printing no result, when JAX finds no GPU. Otherwise it
prints one JSON line:
    {"metric", "value", "unit", "vs_baseline", "device", "context"}

    python bench.py
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax
import jax.numpy as jnp

import tcnn_tpu as tc
from tcnn_tpu.utils.device import NoGpuError, device_info, nvidia_smi, require_gpu
from tcnn_tpu.utils.image import (
    build_quad_table_packed,
    sample_image_quad_packed,
    synthetic_image,
)

BASELINE_SAMPLES_PER_SEC = 1000.0 * (1 << 18)  # RTX 4090, README.md:75
LOG2_BATCH = 18
BATCH_SIZE = 1 << LOG2_BATCH
#: steps per dispatch; warmup and timed counts are multiples of it
SCAN_STEPS = 10
WARMUP_STEPS = 100
TIMED_STEPS = 500


def train_loop(trainer, quad, h, w, batch_size, n_steps):
    """jit(state, key) -> (state, key, last loss) running n_steps training
    steps on fresh random batches sampled from the packed image `quad`."""

    def multi_step(state, key, quad_arg):
        def body(carry, _):
            st, k0 = carry
            k0, k = jax.random.split(k0)
            xy = jax.random.uniform(k, (batch_size, 2))
            rgb = sample_image_quad_packed(quad_arg, h, w, xy)
            st, loss = trainer.train_step_fn(st, xy, rgb)
            return (st, k0), loss

        (state, key), losses = jax.lax.scan(
            body, (state, key), None, length=n_steps
        )
        return state, key, losses[-1]

    step = jax.jit(multi_step, donate_argnums=(0,))
    return lambda state, key: step(state, key, quad)


def inference_loop(network, n_iters):
    """jit(params, x0) -> (x, last output value): n_iters forwards of
    `network` (Trainer.inference's op: output trimmed to n_output_dims, fp32)
    whose iterations chain - each input is x0 plus a vanishing multiple of
    the previous output, so no iteration can start before the last ends."""
    nd = network.n_output_dims

    def loop(params, x0):
        def body(x, _):
            out = network.apply(params, x)[:, :nd].astype(jnp.float32)
            return x0 + out[:, :1] * 1e-30, out[-1, -1]

        x, last = jax.lax.scan(body, x0, None, length=n_iters)
        return x, last[-1]

    return jax.jit(loop)


def main():
    try:
        require_gpu()
    except NoGpuError as e:
        sys.exit(f"bench.py: {e}")
    device = device_info(nvidia_smi())
    tc.enable_compilation_cache()

    image = synthetic_image(1024, 1024)
    h, w = image.shape[:2]
    config_path = os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "data", "config_hash.json"
    )
    model = tc.create_from_config(2, 3, tc.load_config(config_path))
    trainer = model.trainer
    quad = jax.jit(build_quad_table_packed)(jnp.asarray(image))
    step = train_loop(trainer, quad, h, w, BATCH_SIZE, SCAN_STEPS)

    state = trainer.state
    key = jax.random.key(1337)
    t0 = time.perf_counter()
    state, key, loss = step(state, key)
    jax.block_until_ready(loss)
    compile_s = time.perf_counter() - t0

    for _ in range(WARMUP_STEPS // SCAN_STEPS - 1):
        state, key, loss = step(state, key)
    jax.block_until_ready(loss)
    t0 = time.perf_counter()
    for _ in range(TIMED_STEPS // SCAN_STEPS):
        state, key, loss = step(state, key)
    jax.block_until_ready(loss)
    samples_per_sec = TIMED_STEPS * BATCH_SIZE / (time.perf_counter() - t0)
    final_loss = float(loss)
    trainer.state = state

    infer = inference_loop(model.network, SCAN_STEPS)
    params = trainer.inference_params
    xy = jax.random.uniform(jax.random.PRNGKey(7), (BATCH_SIZE, 2))
    xy_c, last = infer(params, xy)
    jax.block_until_ready(last)
    t0 = time.perf_counter()
    for _ in range(TIMED_STEPS // SCAN_STEPS):
        xy_c, last = infer(params, xy_c)
    jax.block_until_ready(last)
    inf_samples_per_sec = TIMED_STEPS * BATCH_SIZE / (time.perf_counter() - t0)

    print(
        json.dumps(
            {
                "metric": f"image_train_throughput_config_hash_b2^{LOG2_BATCH}",
                "value": samples_per_sec,
                "unit": "samples/s",
                "vs_baseline": samples_per_sec / BASELINE_SAMPLES_PER_SEC,
                "device": device,
                "context": {
                    "inference_samples_per_sec": inf_samples_per_sec,
                    "final_loss": final_loss,
                    "compile_s": compile_s,
                    "mlp_route": model.network.network.route,
                },
            }
        )
    )


if __name__ == "__main__":
    main()
