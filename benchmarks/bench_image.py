#!/usr/bin/env python
"""Image-training throughput sweep - port of the reference benchmark
protocol (benchmarks/image/bench_ours.cu:188-332):

  for method in {FullyFusedMLP, CutlassMLP}:
    for batch_size in 2^14 .. 2^21:
      measure mean training and inference throughput (samples/s) after a
      warmup of half the iterations

and write bench_result_ours.json in the same shape as the reference
({"tcnn_tpu": [{n_neurons, n_hidden_layers, batch_size, ...}]}).

The iteration counts scale inversely with batch size like the reference
(bench_ours.cu:200: n_iterations ~ max target_samples/batch).

Runs on one NVIDIA GPU and exits non-zero when JAX finds none. Every timed
window ends in `block_until_ready`; every row names the device.

Usage: python benchmarks/bench_image.py [config.json] [output.json]
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np

import tcnn_tpu as tc
from tcnn_tpu.utils.device import NoGpuError, device_info, nvidia_smi, require_gpu
from tcnn_tpu.utils.image import build_quad_table, sample_image_quad, synthetic_image

TARGET_SAMPLES = 1 << 24  # samples per measurement


def bench_config(config, image, batch_sizes, device):
    h, w = image.shape[:2]
    quad = jax.jit(build_quad_table)(jnp.asarray(image))
    results = []
    for bs in batch_sizes:
        model = tc.create_from_config(2, 3, config)
        trainer = model.trainer

        def step(state, quad, key):
            key, k = jax.random.split(key)
            xy = jax.random.uniform(k, (bs, 2))
            rgb = sample_image_quad(quad, h, w, xy)
            state, loss = trainer.train_step_fn(state, xy, rgb)
            return state, key, loss

        _jstep = jax.jit(step, donate_argnums=(0,))
        jstep = lambda state, key: _jstep(state, quad, key)

        def infer(params, key):
            key, k = jax.random.split(key)
            xy = jax.random.uniform(k, (bs, 2))
            out = model.network.apply(params, xy)
            return key, out

        jinfer = jax.jit(infer)

        n_iters = max(TARGET_SAMPLES // bs, 8)
        warmup = n_iters // 2

        state = trainer.state
        key = jax.random.PRNGKey(1337)
        for _ in range(warmup):
            state, key, loss = jstep(state, key)
        jax.block_until_ready(loss)
        t0 = time.perf_counter()
        for _ in range(n_iters):
            state, key, loss = jstep(state, key)
        jax.block_until_ready(loss)
        train_tp = n_iters * bs / (time.perf_counter() - t0)

        params = state["params"]
        for _ in range(warmup):
            key, out = jinfer(params, key)
        jax.block_until_ready(out)
        t0 = time.perf_counter()
        for _ in range(n_iters):
            key, out = jinfer(params, key)
        jax.block_until_ready(out)
        infer_tp = n_iters * bs / (time.perf_counter() - t0)

        row = {
            "device": device,
            "otype": str(config["network"].get("otype")),
            "n_neurons": int(config["network"].get("n_neurons", 64)),
            "n_hidden_layers": int(config["network"].get("n_hidden_layers", 2)),
            "batch_size": bs,
            "training_throughput": train_tp,
            "inference_throughput": infer_tp,
            "final_loss": float(loss),
        }
        results.append(row)
        sys.stderr.write(
            f"# {row['otype']} bs=2^{int(np.log2(bs))}: "
            f"train {train_tp/1e6:.2f} M/s, infer {infer_tp/1e6:.2f} M/s\n"
        )
    return results


def main():
    try:
        require_gpu()
    except NoGpuError as e:
        sys.exit(f"bench_image.py: {e}")
    device = device_info(nvidia_smi())
    tc.enable_compilation_cache()
    config_path = (
        sys.argv[1]
        if len(sys.argv) > 1
        else os.path.join(os.path.dirname(__file__), "..", "data", "config_oneblob.json")
    )
    out_path = sys.argv[2] if len(sys.argv) > 2 else "bench_result_ours.json"

    image = synthetic_image(1024, 1024)
    base = tc.load_config(config_path)
    batch_sizes = [1 << e for e in range(14, 22)]

    all_rows = []
    for otype in ("FullyFusedMLP", "CutlassMLP"):
        cfg = json.loads(json.dumps(base))
        cfg["network"]["otype"] = otype
        all_rows += bench_config(cfg, image, batch_sizes, device)

    with open(out_path, "w") as f:
        json.dump({"tcnn_tpu": all_rows}, f, indent=1)
    print(json.dumps({"wrote": out_path, "rows": len(all_rows)}))


if __name__ == "__main__":
    main()
