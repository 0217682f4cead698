"""The fused MLP kernels (ops/pallas/mlp_kernel.py) and the route choice.

Here the kernels run in the Pallas interpreter (`interpret=True`) and are
compared with XLA's bf16 chain (CutlassMLP.apply), which rounds at the same
points: bf16 operands and activations, fp32 accumulation. The `gpu` tests
compile them for the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tcnn_tpu import reference
from tcnn_tpu.common import Activation
from tcnn_tpu.models.mlp import CutlassMLP, FullyFusedMLP, mlp_route
from tcnn_tpu.ops.pallas import mlp_kernel
from tcnn_tpu.ops.pallas.mlp_kernel import fused_mlp_apply


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _kernel_vs_chain(n_in, width, n_hidden, n_out, act, batch):
    mlp = FullyFusedMLP(n_in, n_out, n_neurons=width,
                        n_hidden_layers=n_hidden, activation=act)
    params = jnp.asarray(mlp.init_params(jax.random.PRNGKey(0)))
    x = jax.random.uniform(jax.random.PRNGKey(1), (batch, n_in),
                           minval=-1.0).astype(jnp.bfloat16)
    gy = jax.random.normal(jax.random.PRNGKey(2),
                           (batch, mlp.padded_output_width))

    def grads(apply):
        return jax.grad(
            lambda p, xx: jnp.sum(apply(p, xx).astype(jnp.float32) * gy),
            argnums=(0, 1),
        )(params, x)

    kernel = lambda p, xx: fused_mlp_apply(mlp, p, xx, interpret=True)  # noqa: E731
    chain = lambda p, xx: CutlassMLP.apply(mlp, p, xx)  # noqa: E731
    y_k, y_c = kernel(params, x), chain(params, x)
    assert y_k.shape == (batch, mlp.padded_output_width)
    assert y_k.dtype == jnp.bfloat16
    (dw_k, dx_k), (dw_c, dx_c) = grads(kernel), grads(chain)
    assert dx_k.shape == x.shape and dw_k.shape == params.shape
    return {"y": _rel(y_k, y_c), "dW": _rel(dw_k, dw_c), "dx": _rel(dx_k, dx_c)}


@pytest.mark.parametrize("width", [16, 32, 64])
@pytest.mark.parametrize("n_hidden", [1, 5])
def test_kernel_matches_xla_chain(width, n_hidden):
    err = _kernel_vs_chain(32, width, n_hidden, 3, Activation.ReLU, 256)
    # same rounding points; the kernel keeps dW in fp32 where the chain
    # rounds it to bf16
    assert err["y"] < 1e-2 and err["dW"] < 2e-2 and err["dx"] < 2e-2, err


@pytest.mark.parametrize("act", [Activation.Sigmoid, Activation.Tanh,
                                 Activation.Softplus, Activation.Exponential])
def test_kernel_activations(act):
    err = _kernel_vs_chain(16, 16, 2, 3, act, 128)
    assert max(err.values()) < 2e-2, err


@pytest.mark.parametrize("n_in,n_out,batch", [(48, 3, 300), (16, 20, 130),
                                              (100, 1, 1)])
def test_kernel_pads_widths_and_batch(n_in, n_out, batch):
    """Input widths and batches off a power of two / tile multiple."""
    err = _kernel_vs_chain(n_in, 32, 2, n_out, Activation.LeakyReLU, batch)
    assert max(err.values()) < 2e-2, err


def test_kernel_against_numpy_reference():
    mlp = FullyFusedMLP(32, 3, n_neurons=64, n_hidden_layers=2)
    params = np.asarray(mlp.init_params(jax.random.PRNGKey(4)))
    x = jnp.asarray(np.random.default_rng(5).uniform(0, 1, (256, 32)),
                    jnp.bfloat16)
    y = fused_mlp_apply(mlp, jnp.asarray(params), x, interpret=True)
    y_r, _, _ = reference.mlp_forward_backward(
        mlp, params, np.asarray(x.astype(jnp.float32)),
        np.zeros((256, 16)),
    )
    assert _rel(y, y_r) < 2e-2


def test_grid_splits_tiles_over_programs():
    # 2^18 rows: 2048 tiles over 256 programs of 8 tiles each
    assert mlp_kernel._grid(1 << 18) == (256, 8, 2048)
    # fewer tiles than programs: one tile each
    assert mlp_kernel._grid(384) == (3, 1, 3)
    # ragged: the last program takes the remainder
    n_prog, tiles, n_tiles = mlp_kernel._grid(300 * 128)
    assert tiles == 2 and n_prog == 150 and n_tiles == 300


def test_weights_padded_to_powers_of_two():
    mlp = FullyFusedMLP(48, 20, n_neurons=32, n_hidden_layers=2)
    params = jnp.asarray(mlp.init_params(jax.random.PRNGKey(0)))
    wts = mlp_kernel._weights_t(mlp, params)
    assert [w.shape for w in wts] == [(64, 32), (32, 32), (32, 32)]
    assert all(w.dtype == jnp.bfloat16 for w in wts)
    assert float(jnp.abs(wts[0][48:]).max()) == 0.0


@pytest.mark.parametrize(
    "width,act,platform,route",
    [
        (64, Activation.ReLU, "gpu", "triton"),
        (16, Activation.Sigmoid, "gpu", "triton"),
        (32, Activation.Tanh, "gpu", "triton"),
        (64, Activation.Sine, "gpu", "xla"),
        (128, Activation.ReLU, "gpu", "xla"),
        (64, Activation.ReLU, "cpu", "xla"),
    ],
)
def test_mlp_route(width, act, platform, route):
    mlp = FullyFusedMLP(32, 3, n_neurons=width, n_hidden_layers=2,
                        activation=act)
    assert mlp_route(mlp, platform) == route


def test_route_xla_for_weights_beyond_chip():
    mlp = FullyFusedMLP(4096, 3, n_neurons=64, n_hidden_layers=2)
    assert mlp_route(mlp, "gpu") == "xla"


def test_route_fixed_at_construction_on_this_backend():
    mlp = FullyFusedMLP(32, 3, n_neurons=64, n_hidden_layers=2)
    assert mlp.route == mlp_route(mlp, jax.default_backend())


def test_unsupported_mlp_is_refused():
    mlp = FullyFusedMLP(32, 3, n_neurons=64, n_hidden_layers=2,
                        activation=Activation.Sine)
    with pytest.raises(ValueError, match="do not cover"):
        fused_mlp_apply(mlp, jnp.zeros(mlp.n_params), jnp.zeros((8, 32)),
                        interpret=True)


@pytest.mark.gpu
@pytest.mark.parametrize("width", [16, 32, 64])
def test_kernel_on_gpu_matches_reference(gpu_device, width):
    """Compiled for the card at a real batch: forward and dW against the
    float64 reference with a positive cotangent (PERF.md, parity)."""
    mlp = FullyFusedMLP(32, 3, n_neurons=width, n_hidden_layers=2)
    assert mlp.route == "triton"
    b = 1 << 16
    rng = np.random.default_rng(width)
    params = np.asarray(mlp.init_params(jax.random.PRNGKey(width)))
    x = jnp.asarray(rng.uniform(0, 1, (b, 32)), jnp.bfloat16)
    dy = (1.0 + 0.5 * np.cos(np.arange(b)[:, None] * 1e-3
                             + np.arange(16))).astype(np.float32)
    y = mlp.apply(jnp.asarray(params), x)
    dw = jax.grad(lambda p: jnp.sum(mlp.apply(p, x).astype(jnp.float32) * dy))(
        jnp.asarray(params))
    y_r, dw_r, _ = reference.mlp_forward_backward(
        mlp, params, np.asarray(x.astype(jnp.float32)), dy)
    assert _rel(y, y_r) < 2e-2
    assert _rel(dw, dw_r) < 2e-2
