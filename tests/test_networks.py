"""MLP parity tests: parameter layout, activations, shapes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tcnn_tpu.common import Activation, K_ACT
from tcnn_tpu.models.mlp import CutlassMLP, FullyFusedMLP
from tcnn_tpu.ops.activations import (
    activation_bwd_in,
    activation_bwd_out,
    activation_fn,
)

F32 = jnp.float32


def test_param_count_matches_reference_layout():
    # fully_fused_mlp.cu:659-677: [W x in] + (H-1)[W x W] + [pad_out x W]
    mlp = FullyFusedMLP(32, 3, n_neurons=64, n_hidden_layers=2)
    assert mlp.padded_output_width == 16
    assert mlp.n_params == 64 * 32 + 64 * 64 + 16 * 64
    assert mlp.layer_sizes() == [(64, 32), (64, 64), (16, 64)]


def test_cutlass_zero_hidden_layers():
    # cutlass_mlp.cu:64-67: 0 hidden layers = single matmul
    mlp = CutlassMLP(16, 4, n_neurons=64, n_hidden_layers=0,
                     output_activation=Activation.Sigmoid)
    assert mlp.layer_sizes() == [(16, 16)]
    p = jnp.asarray(mlp.init_params(jax.random.PRNGKey(0)))
    y = mlp.apply(p, jnp.ones((8, 16)), compute_dtype=F32)
    assert y.shape == (8, 16)
    assert (np.asarray(y) > 0).all() and (np.asarray(y) < 1).all()


def test_forward_matches_manual_matmul_chain():
    mlp = CutlassMLP(16, 3, n_neurons=32, n_hidden_layers=2,
                     activation=Activation.ReLU)
    p = np.asarray(mlp.init_params(jax.random.PRNGKey(1)))
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(2), (4, 16)))

    w1 = p[: 32 * 16].reshape(32, 16)
    w2 = p[32 * 16 : 32 * 16 + 32 * 32].reshape(32, 32)
    w3 = p[32 * 16 + 32 * 32 :].reshape(16, 32)
    h = np.maximum(x @ w1.T, 0)
    h = np.maximum(h @ w2.T, 0)
    expected = h @ w3.T

    y = np.asarray(mlp.apply(jnp.asarray(p), jnp.asarray(x), compute_dtype=F32))
    np.testing.assert_allclose(y, expected, rtol=1e-4, atol=1e-5)


def test_fully_fused_width_restriction():
    with pytest.raises(ValueError):
        FullyFusedMLP(16, 3, n_neurons=48)
    with pytest.raises(ValueError):
        FullyFusedMLP(16, 3, n_neurons=64, n_hidden_layers=0)


def test_siren_init_scale():
    mlp = CutlassMLP(16, 3, n_neurons=32, n_hidden_layers=2,
                     activation=Activation.Sine)
    p = np.asarray(mlp.init_params(jax.random.PRNGKey(3)))
    w1 = p[: 32 * 16]
    # first layer: U(+-30/fan_in) (gpu_matrix.h:354-378)
    assert np.abs(w1).max() <= 30.0 / 16 + 1e-6
    assert np.abs(w1).max() > 30.0 / 16 * 0.8
    w2 = p[32 * 16 : 32 * 16 + 32 * 32]
    assert np.abs(w2).max() <= np.sqrt(6.0 / 32) + 1e-6


ACTS = [a for a in Activation]


@pytest.mark.parametrize("act", ACTS)
def test_activation_derivative_consistency(act):
    """activation_bwd_in must equal jax.grad of activation_fn."""
    x = jnp.linspace(-2, 2, 41)
    x = x[jnp.abs(x) > 1e-3]  # avoid the ReLU kink at 0
    g_auto = jax.vmap(jax.grad(lambda v: activation_fn(v, act)))(x)
    g_ours = activation_bwd_in(jnp.ones_like(x), x, act)
    np.testing.assert_allclose(np.asarray(g_ours), np.asarray(g_auto),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("act", [a for a in Activation if a != Activation.Sine])
def test_activation_bwd_from_output(act):
    x = jnp.linspace(-1.5, 1.5, 31)
    x = x[jnp.abs(x) > 1e-3]
    y = activation_fn(x, act)
    g_in = activation_bwd_in(jnp.ones_like(x), x, act)
    g_out = activation_bwd_out(jnp.ones_like(x), y, act)
    np.testing.assert_allclose(np.asarray(g_out), np.asarray(g_in),
                               rtol=1e-3, atol=1e-5)


def test_squareplus_softplus_k_act():
    # DOCUMENTATION.md: Squareplus = 0.5*(X + sqrt(X^2+4))/10 with X = 10 x
    x = jnp.asarray([0.123])
    sq = activation_fn(x, Activation.Squareplus)
    xk = 0.123 * K_ACT
    np.testing.assert_allclose(
        float(sq[0]), 0.5 * (xk + np.sqrt(xk * xk + 4)) / K_ACT, rtol=1e-6
    )
    sp = activation_fn(x, Activation.Softplus)
    np.testing.assert_allclose(
        float(sp[0]), np.log(np.exp(xk) + 1) / K_ACT, rtol=1e-6
    )
