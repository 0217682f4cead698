"""Golden loss-trajectory regression test.

A fixed-seed 60-step training run on the CPU composed path must reproduce
the recorded loss trajectory (tests/golden/trajectory.npz) to float
tolerance. Catches silent numeric drift in ANY layer - encoding indexing,
interpolation, loss math, Adam semantics, RNG plumbing.

Regenerate (only after an INTENTIONAL numeric change, with justification):
    python tests/test_trajectory.py --regen
"""

import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np

TRAJ_PATH = pathlib.Path(__file__).parent / "golden" / "trajectory.npz"

CONFIG = {
    "loss": {"otype": "RelativeL2"},
    "optimizer": {"otype": "Adam", "learning_rate": 1e-2, "beta1": 0.9,
                  "beta2": 0.99, "epsilon": 1e-15, "l2_reg": 1e-6},
    "encoding": {"otype": "HashGrid", "n_levels": 8,
                 "n_features_per_level": 2, "log2_hashmap_size": 13,
                 "base_resolution": 8, "per_level_scale": 1.5},
    "network": {"otype": "FullyFusedMLP", "n_neurons": 64,
                "n_hidden_layers": 2},
}
N_STEPS = 60


def _run_trajectory():
    import tcnn_tpu as tc

    m = tc.create_from_config(2, 3, CONFIG)
    key = jax.random.PRNGKey(1337)
    losses = []
    for _ in range(N_STEPS):
        key, k = jax.random.split(key)
        x = jax.random.uniform(k, (2048, 2))
        t = jnp.stack(
            [jnp.sin(6 * x[:, 0]) * 0.5 + 0.5,
             jnp.cos(4 * x[:, 1]) * 0.5 + 0.5,
             x[:, 0] * x[:, 1]],
            -1,
        )
        losses.append(float(m.trainer.training_step(x, t)))
    psum = float(jnp.sum(m.trainer.params))
    return np.asarray(losses, np.float64), psum


def test_golden_loss_trajectory():
    ref = np.load(TRAJ_PATH)
    losses, psum = _run_trajectory()
    np.testing.assert_allclose(
        losses, ref["losses"], rtol=2e-4,
        err_msg="loss trajectory drifted - if intentional, regenerate with "
                "`python tests/test_trajectory.py --regen` and justify in "
                "the commit message",
    )
    np.testing.assert_allclose(psum, float(ref["param_sum"]), rtol=2e-3)


if __name__ == "__main__":
    if "--regen" in sys.argv:
        jax.config.update("jax_platforms", "cpu")
        losses, psum = _run_trajectory()
        TRAJ_PATH.parent.mkdir(parents=True, exist_ok=True)
        np.savez(TRAJ_PATH, losses=losses, param_sum=psum)
        print(f"wrote {TRAJ_PATH}: first={losses[0]:.6f} "
              f"last={losses[-1]:.6f} param_sum={psum:.6f}")
