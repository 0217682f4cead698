#!/usr/bin/env python
"""Fit a signed-distance field with a 3-D hash grid + MLP.

The 3-D counterpart of the image demo, exercising the fork's main use case
(the reference's gradcheck suite trains an SDF with an eikonal term,
scripts/test_grid_bwdbwd.py:80-102): supervise distances to an analytic
shape (sphere-box blend) and regularize with ||grad f|| = 1 through
second-order autodiff inside the jitted step.

Usage: python samples/learn_a_sdf.py [encoding_otype] [n_steps]
    encoding_otype: HashGrid (default) | PPNG1 | PPNG2 | PPNG3
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np

import tcnn_tpu as tc

ENCODINGS = {
    "HashGrid": {
        "otype": "HashGrid",
        "n_levels": 12,
        "n_features_per_level": 2,
        "log2_hashmap_size": 17,
        "base_resolution": 8,
        "per_level_scale": 1.5,
    },
    "PPNG1": {"otype": "PPNG1", "n_quants": 64, "n_frequencies": 6,
              "n_features": 4, "rank": 4},
    "PPNG2": {"otype": "PPNG2", "n_quants": 32, "n_frequencies": 4,
              "n_features": 2, "rank": 2},
    "PPNG3": {"otype": "PPNG3", "n_quants": 32, "n_frequencies": 4,
              "n_features": 2},
}


def sdf_true(p):
    """Blend of a sphere and a rounded box, centered in [0,1]^3."""
    q = p - 0.5
    sphere = jnp.linalg.norm(q, axis=-1) - 0.3
    box = jnp.linalg.norm(jnp.maximum(jnp.abs(q) - 0.22, 0.0), axis=-1) - 0.05
    return jnp.minimum(sphere, box)


def make_train_step(model, batch=1 << 16, eik_weight=0.01):
    """jit(state) -> (state, loss): one step on a fresh batch of `batch`
    points, L2 to the true distance plus `eik_weight` times the eikonal
    term on the first 1024 points (second-order autodiff in the step)."""
    trainer = model.trainer

    def loss_fn(params, key):
        xs = jax.random.uniform(key, (batch, 3))
        d = sdf_true(xs)[:, None]
        out = model.network.apply(params, xs)[:, :1].astype(jnp.float32)
        data = jnp.mean((out - d) ** 2)

        # eikonal regularizer on a subsample (2nd-order path in training).
        # prepare_input_gradients=True is REQUIRED for d/dx (same contract
        # as the reference's prepare_input_gradients); the sum trick gives
        # per-sample grads in ONE batched vjp (outputs are per-sample
        # independent).
        xe = xs[:1024]

        def f_batch(pts):
            out = model.network.apply(
                params, pts, prepare_input_gradients=True
            )
            return jnp.sum(out[:, 0].astype(jnp.float32))

        grads = jax.grad(f_batch)(xe)
        eik = jnp.mean((jnp.linalg.norm(grads, axis=-1) - 1.0) ** 2)
        return data + eik_weight * eik

    def step(state):
        k1, k2 = jax.random.split(state["rng"])
        lv, grads = jax.value_and_grad(loss_fn)(state["params"], k1)
        opt_state, params = trainer.optimizer.step(
            state["opt"], 1.0, state["params"], grads * trainer.loss_scale
        )
        return {"params": params, "opt": opt_state, "rng": k2}, lv

    return jax.jit(step)


def sdf_config(otype="HashGrid"):
    return {
        "loss": {"otype": "L2"},
        "optimizer": {"otype": "Adam", "learning_rate": 3e-3},
        "encoding": ENCODINGS[otype],
        "network": {"otype": "FullyFusedMLP", "n_neurons": 64,
                    "n_hidden_layers": 2},
    }


def main(argv):
    otype = argv[1] if len(argv) > 1 else "HashGrid"
    n_steps = int(argv[2]) if len(argv) > 2 else 2000
    model = tc.create_from_config(3, 1, sdf_config(otype))
    print(f"SDF with {otype}: {model.network.n_params} params")
    opt_step = make_train_step(model)

    state = trainer.state
    t0 = time.time()
    interval = 10
    for step in range(1, n_steps + 1):
        state, lv = opt_step(state)
        if step % interval == 0 or step == n_steps:
            jax.block_until_ready(lv)
            print(f"step {step}: loss {float(lv):.6e} "
                  f"({step / (time.time() - t0):.1f} steps/s)")
            if step // interval == 10:
                interval *= 10

    # evaluate surface accuracy on a grid slice
    n = 128
    u = (jnp.arange(n) + 0.5) / n
    xx, yy = jnp.meshgrid(u, u)
    pts = jnp.stack([xx.ravel(), yy.ravel(), jnp.full(n * n, 0.5)], -1)
    pred = model.network.apply(state["params"], pts)[:, 0].astype(jnp.float32)
    err = float(jnp.mean(jnp.abs(pred - sdf_true(pts))))
    print(f"mean |SDF error| on z=0.5 slice: {err:.5f}")


if __name__ == "__main__":
    main(sys.argv)
