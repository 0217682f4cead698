"""MLPs against the float64 numpy reference (tcnn_tpu/reference.py).

Route-agnostic: the models are called through their public `apply`, so the
cases hold for whichever implementation `mlp_route` picks. Computed in
float32 under highest matmul precision, so the bounds test the math
(layout, activations, padding, gradients), not bf16 rounding.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tcnn_tpu import reference
from tcnn_tpu.common import Activation
from tcnn_tpu.models.mlp import CutlassMLP, FullyFusedMLP

F32 = jnp.float32
TOL = 2e-5


@functools.lru_cache(maxsize=None)
def _compare(cls, width, act, n_hidden, batch, n_in, n_out):
    """Relative L2 errors {"y", "dW", "dx"} of cls(...).apply vs numpy."""
    mlp = cls(n_in, n_out, n_neurons=width, n_hidden_layers=n_hidden,
              activation=act, output_activation=Activation.NONE)
    rng = np.random.default_rng(width * 31 + n_hidden)
    params = np.asarray(mlp.init_params(jax.random.PRNGKey(width)))
    x = rng.uniform(-1.0, 1.0, (batch, n_in)).astype(np.float32)
    dy = rng.normal(size=(batch, mlp.padded_output_width)).astype(np.float32)

    def loss(p, xx):
        return jnp.sum(mlp.apply(p, xx, compute_dtype=F32) * dy)

    with jax.default_matmul_precision("highest"):
        y = mlp.apply(jnp.asarray(params), jnp.asarray(x), compute_dtype=F32)
        dw, dx = jax.grad(loss, argnums=(0, 1))(
            jnp.asarray(params), jnp.asarray(x)
        )
    y_r, dw_r, dx_r = reference.mlp_forward_backward(mlp, params, x, dy)

    def rel(a, b):
        return float(np.linalg.norm(np.asarray(a) - b) / np.linalg.norm(b))

    return {"y": rel(y, y_r), "dW": rel(dw, dw_r), "dx": rel(dx, dx_r)}


@pytest.mark.parametrize("quantity", ["y", "dW", "dx"])
@pytest.mark.parametrize("act", list(Activation), ids=lambda a: a.value)
@pytest.mark.parametrize("width", [16, 32, 64, 128])
def test_fully_fused_mlp_matches_reference(width, act, quantity):
    err = _compare(FullyFusedMLP, width, act, 2, 96, 32, 3)
    assert err[quantity] < TOL, err


@pytest.mark.parametrize("n_hidden", [1, 2, 5])
def test_hidden_layer_counts(n_hidden):
    err = _compare(FullyFusedMLP, 64, Activation.ReLU, n_hidden, 128, 32, 3)
    assert max(err.values()) < TOL, err


@pytest.mark.parametrize("batch", [1, 37, 300])
def test_batches_not_a_tile_multiple(batch):
    err = _compare(FullyFusedMLP, 32, Activation.Tanh, 2, batch, 16, 3)
    assert max(err.values()) < TOL, err


@pytest.mark.parametrize("n_out,padded", [(1, 16), (16, 16), (17, 32), (40, 48)])
def test_padded_output_widths(n_out, padded):
    mlp = FullyFusedMLP(16, n_out, n_neurons=32, n_hidden_layers=1)
    assert mlp.padded_output_width == padded
    err = _compare(FullyFusedMLP, 32, Activation.Sigmoid, 1, 64, 16, n_out)
    assert max(err.values()) < TOL, err


@pytest.mark.parametrize("n_hidden", [0, 3])
def test_cutlass_mlp_matches_reference(n_hidden):
    err = _compare(CutlassMLP, 48, Activation.LeakyReLU, n_hidden, 80, 24, 5)
    assert max(err.values()) < TOL, err
