"""Adam (generalized to AdaBound) with tcnn-exact semantics.

Mirror of adam_step (/root/reference/include/tiny-cuda-nn/optimizers/adam.h:47-188):
  - *lazy* per-parameter step counters: a non-matrix parameter whose gradient
    is exactly zero this step is skipped entirely - no moment decay, no step
    increment, no weight decay (adam.h:77-84). This matters enormously for
    hash-grid training where most table rows are untouched each step.
  - L2 regularization applied to matrix (network) weights only (adam.h:88-91)
  - per-parameter debiasing from the lazy step counters (adam.h:103-105)
  - AdaBound effective-lr clamping using the *global* step (adam.h:156-165)
  - relative/absolute weight decay scaled by the debiased lr (adam.h:110)
  - optional weight clipping; separate non-matrix lr factor; matrix /
    non-matrix enable flags.

The whole update is one fused XLA computation over the flat param vector -
the analog of the reference's single fused kernel.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from .base import Optimizer


class AdamOptimizer(Optimizer):
    def __init__(
        self,
        learning_rate: float = 1e-3,
        beta1: float = 0.9,
        beta2: float = 0.999,
        epsilon: float = 1e-8,
        l2_reg: float = 1e-8,
        relative_decay: float = 0.0,
        absolute_decay: float = 0.0,
        adabound: bool = False,
        clipping_magnitude: float = 0.0,
        non_matrix_learning_rate_factor: float = 1.0,
        optimize_matrix_params: bool = True,
        optimize_non_matrix_params: bool = True,
    ):
        super().__init__()
        self.base_learning_rate = float(learning_rate)
        self.beta1 = float(beta1)
        self.beta2 = float(beta2)
        self.epsilon = float(epsilon)
        self.l2_reg = float(l2_reg)
        self.relative_decay = float(relative_decay)
        self.absolute_decay = float(absolute_decay)
        self.adabound = bool(adabound)
        self.clipping_magnitude = float(clipping_magnitude)
        self.non_matrix_learning_rate_factor = float(non_matrix_learning_rate_factor)
        self.optimize_matrix_params = bool(optimize_matrix_params)
        self.optimize_non_matrix_params = bool(optimize_non_matrix_params)

    def init_state(self):
        n = self.n_weights
        return {
            "first_moments": jnp.zeros((n,), jnp.float32),
            "second_moments": jnp.zeros((n,), jnp.float32),
            "param_steps": jnp.zeros((n,), jnp.uint32),
            "step": jnp.zeros((), jnp.uint32),
        }

    def step(self, state, loss_scale, weights, grads, lr_scale=1.0):
        n = self.n_weights
        n_matrix = self.n_matrix_weights
        is_matrix = jnp.asarray(np.arange(n) < n_matrix)

        g = grads.astype(jnp.float32) / loss_scale

        # skip rule (adam.h:76-84)
        active = jnp.where(
            is_matrix,
            self.optimize_matrix_params,
            jnp.logical_and(self.optimize_non_matrix_params, g != 0.0),
        )

        g = jnp.where(is_matrix, g + self.l2_reg * weights, g)

        m1 = self.beta1 * state["first_moments"] + (1 - self.beta1) * g
        m2 = self.beta2 * state["second_moments"] + (1 - self.beta2) * g * g

        step = state["step"] + 1
        param_steps = state["param_steps"] + active.astype(jnp.uint32)
        t = param_steps.astype(jnp.float32)

        base_lr = self.base_learning_rate * lr_scale
        lr = jnp.where(
            is_matrix,
            base_lr,
            base_lr * self.non_matrix_learning_rate_factor,
        )
        lr = lr * jnp.sqrt(1 - self.beta2**t) / (1 - self.beta1**t)

        if self.adabound:
            # adam.h:156-165 - bounds from the *global* step
            gs = step.astype(jnp.float32)
            lower = 0.1 - 0.1 / ((1 - self.beta2) * gs + 1)
            upper = 0.1 + 0.1 / ((1 - self.beta2) * gs)
        else:
            lower, upper = 0.0, jnp.float32(np.finfo(np.float32).max)

        eff_lr = jnp.clip(lr / (jnp.sqrt(m2) + self.epsilon), lower, upper)

        # weight_decay(rel*lr, abs*lr, w) (common_device.h:869-872)
        decayed = (1 - self.relative_decay * lr) * weights - jnp.copysign(
            self.absolute_decay * lr, weights
        )
        new_w = decayed - eff_lr * m1
        if self.clipping_magnitude != 0.0:
            new_w = jnp.clip(
                new_w, -self.clipping_magnitude, self.clipping_magnitude
            )

        new_state = {
            "first_moments": jnp.where(active, m1, state["first_moments"]),
            "second_moments": jnp.where(active, m2, state["second_moments"]),
            "param_steps": param_steps,
            "step": step,
        }
        return new_state, jnp.where(active, new_w, weights)

    # -- introspection -----------------------------------------------------
    @property
    def learning_rate(self) -> float:
        return self.base_learning_rate

    def set_learning_rate(self, lr: float) -> None:
        self.base_learning_rate = float(lr)

    def hyperparams(self) -> dict:
        return {
            "otype": "Adam",
            "beta1": self.beta1,
            "beta2": self.beta2,
            "epsilon": self.epsilon,
            "learning_rate": self.base_learning_rate,
            "l2_reg": self.l2_reg,
            "adabound": self.adabound,
            "relative_decay": self.relative_decay,
            "absolute_decay": self.absolute_decay,
            "clipping_magnitude": self.clipping_magnitude,
            "non_matrix_learning_rate_factor": self.non_matrix_learning_rate_factor,
            "optimize_matrix_params": self.optimize_matrix_params,
            "optimize_non_matrix_params": self.optimize_non_matrix_params,
        }

    def update_hyperparams(self, params: dict) -> None:
        for key, attr in [
            ("beta1", "beta1"),
            ("beta2", "beta2"),
            ("epsilon", "epsilon"),
            ("learning_rate", "base_learning_rate"),
            ("l2_reg", "l2_reg"),
            ("adabound", "adabound"),
            ("relative_decay", "relative_decay"),
            ("absolute_decay", "absolute_decay"),
            ("clipping_magnitude", "clipping_magnitude"),
            ("non_matrix_learning_rate_factor", "non_matrix_learning_rate_factor"),
            ("optimize_matrix_params", "optimize_matrix_params"),
            ("optimize_non_matrix_params", "optimize_non_matrix_params"),
        ]:
            if key in params:
                setattr(self, attr, params[key])
