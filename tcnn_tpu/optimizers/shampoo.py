"""Shampoo (full second-order) optimizer with tcnn-exact semantics.

Mirror of ShampooOptimizer
(/root/reference/include/tiny-cuda-nn/optimizers/shampoo.h:286-1050). The
reference spreads the work over cuBLAS batched GEMMs on forked streams plus
a host-synchronized coupled-Newton iteration; here the whole update is one
XLA program - the Gram updates, the inverse-4th-root Newton iterations and
the preconditioned step are all matmuls inside the jitted train step.

Semantics carried over exactly:
  - streaming-debiased EMAs: alpha/beta pairs from debiased_alpha_beta
    (shampoo.h:311-321) with the step count BEFORE increment.
  - momentum m = m1/(sqrt(m2)+eps) with l2-regularized unscaled gradient
    (shampoo_momentum_update_batched, shampoo.h:167-192).
  - per-layer Gram factors L = b3 L + a3 G G^T, R = b3 R + a3 G^T G, on the
    momentum when cg_on_momentum (default) else on the raw loss-scaled
    gradients with a3 /= loss_scale^2 (shampoo.h:634-660, 725-760).
  - preconditioned update U = L^{-1/4} M R^{-1/4}; shampoo momentum
    s = b_sh s + a_sh U; applied only from the second step on
    (shampoo.h:765-816).
  - Frobenius normalization: lr *= ||m||_F / ||s||_F per matrix
    (shampoo_step_batched, shampoo.h:248-251).
  - weight decay via weight_decay(rel*lr, abs*lr, w)
    (common_device.h:870-873); non-matrix params take the momentum SGD
    update every step (shampoo_step_remaining, shampoo.h:264-282).
  - root refresh schedule: every step<100 ? 10 : 200 steps, round-robin
    over same-shape layer groups; all groups at step 1 (shampoo.h:831-856).
  - inverse 4th root by the coupled Newton iteration of Higham's
    "Functions of Matrices" sec 3.2 as implemented in
    inverse_pth_root_batched (shampoo.h:434-637): spectral bound from
    ||A^4||_F, X_{k+1} = X_k (5I - M_k)/4, M_{k+1} = ((5I - M_k)/4)^4 M_k,
    run a fixed 30 iterations (the reference iterates to 1e-20 with a host
    sync; 30 is past its typical convergence point).

The reference does not support serialize/deserialize (shampoo.h:966-972);
here the state is a plain pytree so checkpointing works anyway (a strict
superset).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .base import Optimizer

_NEWTON_ITERS = 30


def _debiased_alpha_beta(decay, t):
    """(alpha, beta) per shampoo.h:311-321; t is the pre-increment step."""
    tf = t.astype(jnp.float32)
    debias = 1.0 - decay ** (tf + 1.0)
    alpha = (1.0 - decay) / debias
    beta = decay * (1.0 - decay**tf) / debias
    return alpha, beta


def inverse_fourth_root(a):
    """Batched A^{-1/4} for SPD a [G, M, M] f32 (shampoo.h:434-637)."""
    m = a.shape[-1]
    eye = jnp.eye(m, dtype=jnp.float32)[None]

    a2 = a @ a
    a4 = a2 @ a2
    c = jnp.sum(a4 * a4, axis=(-2, -1), keepdims=True)  # ||A^4||_F^2
    s = jnp.sqrt(2.0) / c**0.125
    mk = a * s
    x = eye * s**0.25

    t = (5.0 * eye - mk) * 0.25
    x = x @ t

    def body(_, carry):
        x, mk, t = carry
        t2 = t @ t
        t4 = t2 @ t2
        mk = t4 @ mk
        t = (5.0 * eye - mk) * 0.25
        x = x @ t
        return x, mk, t

    x, _, _ = jax.lax.fori_loop(0, _NEWTON_ITERS, body, (x, mk, t))
    return x


class ShampooOptimizer(Optimizer):
    def __init__(
        self,
        learning_rate: float = 1e-3,
        beta1: float = 0.9,
        beta2: float = 0.99,
        beta3: float = 0.9,
        beta_shampoo: float = 0.9,
        epsilon: float = 1e-8,
        identity: float = 0.01,
        l2_reg: float = 1e-5,
        relative_decay: float = 0.0,
        absolute_decay: float = 0.0,
        cg_on_momentum: bool = True,
        frobenius_normalization: bool = True,
    ):
        super().__init__()
        self.base_learning_rate = float(learning_rate)
        self.beta1 = float(beta1)
        self.beta2 = float(beta2)
        self.beta3 = float(beta3)
        self.beta_shampoo = float(beta_shampoo)
        self.epsilon = float(epsilon)
        self.identity_strength = float(identity)
        self.l2_reg = float(l2_reg)
        self.relative_decay = float(relative_decay)
        self.absolute_decay = float(absolute_decay)
        self.cg_on_momentum = bool(cg_on_momentum)
        self.frobenius_normalization = bool(frobenius_normalization)

    # -- layer grouping (consecutive same-shape runs, shampoo.h:370-395) ----
    def _groups(self):
        groups = []
        if not self._layer_sizes:
            return groups
        start, cur = 0, self._layer_sizes[0]
        off = 0
        start_off = 0
        for i, sz in enumerate(self._layer_sizes):
            if sz != cur:
                groups.append((start, i, cur, start_off))
                start, cur, start_off = i, sz, off
            off += sz[0] * sz[1]
        groups.append((start, len(self._layer_sizes), cur, start_off))
        return groups

    def init_state(self):
        n = self.n_weights
        state = {
            "step": jnp.zeros((), jnp.uint32),
            "first_moments": jnp.zeros((n,), jnp.float32),
            "second_moments": jnp.zeros((n,), jnp.float32),
            "momentum": jnp.zeros((n,), jnp.float32),
            "shampoo_momentum": jnp.zeros((n,), jnp.float32),
        }
        for j, (i0, i1, (m, nn), _) in enumerate(self._groups()):
            g = i1 - i0
            state[f"L_{j}"] = jnp.zeros((g, m, m), jnp.float32)
            state[f"R_{j}"] = jnp.zeros((g, nn, nn), jnp.float32)
            state[f"L_root_{j}"] = jnp.zeros((g, m, m), jnp.float32)
            state[f"R_root_{j}"] = jnp.zeros((g, nn, nn), jnp.float32)
        return state

    def _symmetrize(self, a):
        m = a.shape[-1]
        eye = jnp.eye(m, dtype=jnp.float32)[None]
        return (
            0.5 * (a + jnp.swapaxes(a, -1, -2)) * (1.0 - self.identity_strength)
            + self.identity_strength * eye
        )

    def step(self, state, loss_scale, weights, grads, lr_scale=1.0):
        t = state["step"]  # pre-increment, like m_current_step at entry
        a1, b1 = _debiased_alpha_beta(self.beta1, t)
        a2, b2 = _debiased_alpha_beta(self.beta2, t)
        a3, b3 = _debiased_alpha_beta(self.beta3, t)
        ash, bsh = _debiased_alpha_beta(self.beta_shampoo, t)
        if not self.cg_on_momentum:
            a3 = a3 / (loss_scale * loss_scale)

        step = t + 1  # m_current_step after ++

        g_raw = grads.astype(jnp.float32)
        g = g_raw / loss_scale + self.l2_reg * weights
        m1 = b1 * state["first_moments"] + a1 * g
        m2 = b2 * state["second_moments"] + a2 * g * g
        momentum = m1 / (jnp.sqrt(m2) + self.epsilon)

        lr = self.base_learning_rate * lr_scale
        new_state = {
            "step": step,
            "first_moments": m1,
            "second_moments": m2,
            "momentum": momentum,
            "shampoo_momentum": state["shampoo_momentum"],
        }
        new_w = weights

        groups = self._groups()
        n_batches = max(len(groups), 1)
        # refresh schedule (shampoo.h:831-845)
        update_interval = jnp.where(step < 100, 10, 200)
        single = jnp.maximum(update_interval // n_batches, 1)
        first_step = t == 0

        sh_mom_new = state["shampoo_momentum"]
        for j, (i0, i1, (m, nn), off) in enumerate(groups):
            gcount = i1 - i0
            size = gcount * m * nn
            sl = slice(off, off + size)
            gsrc = momentum if self.cg_on_momentum else g_raw
            gmat = gsrc[sl].reshape(gcount, m, nn)

            L = b3 * state[f"L_{j}"] + a3 * (gmat @ jnp.swapaxes(gmat, -1, -2))
            R = b3 * state[f"R_{j}"] + a3 * (jnp.swapaxes(gmat, -1, -2) @ gmat)
            new_state[f"L_{j}"] = L
            new_state[f"R_{j}"] = R

            # preconditioned update (only from the second step on)
            mom_mat = momentum[sl].reshape(gcount, m, nn)
            u = state[f"L_root_{j}"] @ mom_mat @ state[f"R_root_{j}"]
            sh_old = state["shampoo_momentum"][sl].reshape(gcount, m, nn)
            sh = bsh * sh_old + ash * u

            if self.frobenius_normalization:
                adam_norm = jnp.sum(mom_mat**2, axis=(-2, -1), keepdims=True)
                sh_norm = jnp.sum(sh**2, axis=(-2, -1), keepdims=True)
                lr_mat = lr * jnp.sqrt(adam_norm) / jnp.sqrt(sh_norm + 1e-30)
            else:
                lr_mat = jnp.full((gcount, 1, 1), lr, jnp.float32)

            w_mat = weights[sl].reshape(gcount, m, nn)
            decayed = (1.0 - self.relative_decay * lr_mat) * w_mat - jnp.copysign(
                self.absolute_decay * lr_mat, w_mat
            )
            w_upd = decayed - lr_mat * sh

            apply_mask = jnp.logical_not(first_step)
            w_mat_new = jnp.where(apply_mask, w_upd, w_mat)
            sh_sel = jnp.where(apply_mask, sh, sh_old)
            new_w = new_w.at[sl].set(w_mat_new.reshape(-1))
            sh_mom_new = sh_mom_new.at[sl].set(sh_sel.reshape(-1))

            # root refresh (all groups at step 1; round-robin after). The
            # coupled-Newton iteration (30 batched matmul steps per factor)
            # dominates the optimizer cost, so it must only run on refresh
            # steps - lax.cond skips it entirely off-schedule (matching the
            # reference's host-side schedule, shampoo.h:831-856), unlike a
            # jnp.where which would compute-and-discard every step.
            refresh = jnp.logical_or(
                first_step,
                jnp.logical_and(
                    step % single == 0, (step // single) % n_batches == j
                ),
            )
            new_state[f"L_root_{j}"], new_state[f"R_root_{j}"] = jax.lax.cond(
                refresh,
                lambda L=L, R=R: (
                    inverse_fourth_root(self._symmetrize(L)),
                    inverse_fourth_root(self._symmetrize(R)),
                ),
                lambda j=j: (state[f"L_root_{j}"], state[f"R_root_{j}"]),
            )

        new_state["shampoo_momentum"] = sh_mom_new

        # non-matrix remainder: momentum SGD every step (shampoo.h:264-282)
        n_mat = self.n_matrix_weights
        if n_mat < self.n_weights:
            slr = slice(n_mat, self.n_weights)
            w_r = weights[slr]
            decayed = (1.0 - self.relative_decay * lr) * w_r - jnp.copysign(
                self.absolute_decay * lr, w_r
            )
            new_w = new_w.at[slr].set(decayed - lr * momentum[slr])

        return new_state, new_w

    # -- introspection -----------------------------------------------------
    @property
    def learning_rate(self) -> float:
        return self.base_learning_rate

    def set_learning_rate(self, lr: float) -> None:
        self.base_learning_rate = float(lr)

    def hyperparams(self) -> dict:
        return {
            "otype": "Shampoo",
            "beta1": self.beta1,
            "beta2": self.beta2,
            "beta3": self.beta3,
            "beta_shampoo": self.beta_shampoo,
            "epsilon": self.epsilon,
            "identity": self.identity_strength,
            "learning_rate": self.base_learning_rate,
            "cg_on_momentum": self.cg_on_momentum,
            "frobenius_normalization": self.frobenius_normalization,
            "l2_reg": self.l2_reg,
            "relative_decay": self.relative_decay,
            "absolute_decay": self.absolute_decay,
        }

    def update_hyperparams(self, params: dict) -> None:
        for key, attr in [
            ("beta1", "beta1"),
            ("beta2", "beta2"),
            ("beta3", "beta3"),
            ("beta_shampoo", "beta_shampoo"),
            ("epsilon", "epsilon"),
            ("identity", "identity_strength"),
            ("learning_rate", "base_learning_rate"),
            ("cg_on_momentum", "cg_on_momentum"),
            ("frobenius_normalization", "frobenius_normalization"),
            ("l2_reg", "l2_reg"),
            ("relative_decay", "relative_decay"),
            ("absolute_decay", "absolute_decay"),
        ]:
            if key in params:
                setattr(self, attr, params[key])
