#!/usr/bin/env python
"""mlp_learning_an_image - the canonical tiny-cuda-nn demo.

Port of intent (not code) of samples/mlp_learning_an_image.cu in the
reference: learn (x, y) -> RGB of an image with random-uniform coordinate
batches of 2^18 per step, print loss at exponentially-spaced intervals, and
dump predicted images over the pixel-center lattice.

Usage:
    python samples/mlp_learning_an_image.py [image.jpg] [config.json] \
        [n_steps] [output.jpg]

Defaults mirror the reference: if no image is given, uses the reference's
albert.jpg when mounted, else a synthetic test pattern; default config is
data/config_hash.json.
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
from tcnn_tpu.utils.image import (
    load_image,
    pixel_center_coords,
    sample_image,
    save_image,
    synthetic_image,
)

REFERENCE_IMAGE = "/root/reference/data/images/albert.jpg"


def main(argv):
    args = [a for a in argv[1:] if not a.startswith("--")]
    image_path = args[0] if len(args) > 0 else None
    config_path = (
        args[1]
        if len(args) > 1
        else os.path.join(os.path.dirname(__file__), "..", "data", "config_hash.json")
    )
    n_steps = int(args[2]) if len(args) > 2 else 10_000
    out_path = args[3] if len(args) > 3 else "out.jpg"

    if image_path:
        image = load_image(image_path)
    elif os.path.exists(REFERENCE_IMAGE):
        image = load_image(REFERENCE_IMAGE)
    else:
        image = synthetic_image(1024, 1024)
    h, w = image.shape[:2]
    print(f"image {w}x{h}; config {config_path}; {n_steps} steps")

    config = tc.load_config(config_path)
    model = tc.create_from_config(2, 3, config)
    print(f"model: {model.network.n_params} params")

    image_d = jnp.asarray(image)
    batch_size = 1 << 18

    # Batch pipeline: on-device (jnp) by default; --native-pipeline switches
    # to the C++ host runtime (native/tcnn_host.cpp), which reproduces the
    # reference demo's EXACT deterministic PCG32 coordinate stream
    # (default_rng_t rng{1337}, mlp_learning_an_image.cu:222-266).
    use_native = "--native-pipeline" in argv
    if use_native:
        from tcnn_tpu.native import HostRng

        host_rng = HostRng(1337)
        image_np = np.ascontiguousarray(image, np.float32)

        def make_batch(key):
            xy, rgb = host_rng.image_batch(image_np, batch_size)
            return jnp.asarray(xy), jnp.asarray(rgb)

    else:
        from tcnn_tpu.utils.image import build_quad_table, sample_image_quad

        quad = jax.jit(build_quad_table)(image_d)

        # NOTE: quad must be an ARGUMENT - capturing it would ship 100s of
        # MB as a compile-time constant
        @jax.jit
        def _make_batch(quad, key):
            xy = jax.random.uniform(key, (batch_size, 2))
            return xy, sample_image_quad(quad, h, w, xy)

        def make_batch(key):
            return _make_batch(quad, key)

    key = jax.random.PRNGKey(1337)
    eval_xy = jnp.asarray(pixel_center_coords(h, w))

    print_interval = 10
    t0 = time.time()
    for step in range(1, n_steps + 1):
        key, k = jax.random.split(key)
        xy, rgb = make_batch(k)
        loss = model.trainer.training_step(xy, rgb)

        if step % print_interval == 0 or step == n_steps:
            jax.block_until_ready(loss)
            dt = time.time() - t0
            print(
                f"step {step}: loss {float(loss):.6e} "
                f"({step / dt:.1f} steps/s, {step * batch_size / dt / 1e6:.1f} Msamples/s)"
            )
            if step // print_interval == 10:
                print_interval *= 10

    # render over pixel centers (in chunks to bound memory)
    preds = []
    for i in range(0, eval_xy.shape[0], 1 << 20):
        preds.append(np.asarray(model.trainer.inference(eval_xy[i : i + (1 << 20)])))
    pred = np.concatenate(preds).reshape(h, w, 3)
    mse = float(np.mean((pred - image) ** 2))
    psnr = -10 * np.log10(max(mse, 1e-12))
    print(f"final PSNR {psnr:.2f} dB")
    save_image(out_path, pred)
    print(f"wrote {out_path}")


if __name__ == "__main__":
    main(sys.argv)
