"""MLP networks.

Two models with identical math and parameter layout, mirroring the reference:

  - `CutlassMLP` (otype "CutlassMLP"/"MLP"): arbitrary widths, >= 0 hidden
    layers (src/cutlass_mlp.cu): a chain of XLA matmuls with the activation
    fused into each product's epilogue.
  - `FullyFusedMLP` (otype "FullyFusedMLP"): widths {16, 32, 64, 128}
    (src/fully_fused_mlp.cu:499-632). On a GPU it runs the fused Pallas
    Triton kernels of ops/pallas/mlp_kernel.py, which chain
    matmul -> activation across all layers of a row tile without writing
    hidden activations to device memory; `mlp_route` says when.

Parameter layout (flat fp32, row-major per matrix, matching
fully_fused_mlp.cu:659-677):
    [W_in (width x input_width), W_hidden_1..H-1 (width x width),
     W_out (padded_output_width x width)]
A weight matrix W of shape [rows=fan_out, cols=fan_in] maps y = x @ W^T.

Initialization (gpu_matrix.h:284-379, selected in fully_fused_mlp.cu:866-891):
  Xavier-uniform U(+-sqrt(6/(fan_in+fan_out))) normally; for Sine activation,
  SIREN init: first layer U(+-30/fan_in), others U(+-sqrt(6/fan_in)).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..common import Activation, COMPUTE_DTYPE
from ..ops.activations import activation_fn
from ..ops.pallas.mlp_kernel import fused_mlp_apply
from ..ops.pallas.mlp_kernel import supports as fused_kernel_supports
from .base import Network


class CutlassMLP(Network):
    """General-width MLP; 0 hidden layers = plain (activated) matmul."""

    def __init__(
        self,
        input_width: int,
        n_output_dims: int,
        n_neurons: int = 128,
        n_hidden_layers: int = 5,
        activation: Activation = Activation.ReLU,
        output_activation: Activation = Activation.NONE,
    ):
        super().__init__(input_width, n_output_dims)
        self.n_neurons = int(n_neurons)
        self.n_hidden_layers = int(n_hidden_layers)
        self.activation = activation
        self.output_activation = output_activation

    # -- layout -----------------------------------------------------------
    def layer_sizes(self):
        w, inp, out = self.n_neurons, self.input_width, self.padded_output_width
        if self.n_hidden_layers == 0:
            return [(out, inp)]
        sizes = [(w, inp)]
        sizes += [(w, w)] * (self.n_hidden_layers - 1)
        sizes += [(out, w)]
        return sizes

    @property
    def n_params(self) -> int:
        return sum(r * c for r, c in self.layer_sizes())

    def _split_weights(self, params):
        mats = []
        off = 0
        for r, c in self.layer_sizes():
            mats.append(params[off : off + r * c].reshape(r, c))
            off += r * c
        return mats

    def init_params(self, key) -> np.ndarray:
        sizes = self.layer_sizes()
        keys = jax.random.split(key, len(sizes))
        parts = []
        for i, ((rows, cols), k) in enumerate(zip(sizes, keys)):
            if self.activation == Activation.Sine:
                scale = 30.0 / cols if i == 0 else np.sqrt(6.0 / cols)
            else:
                scale = np.sqrt(6.0 / (cols + rows))
            parts.append(
                np.asarray(
                    jax.random.uniform(
                        k, (rows * cols,), minval=-scale, maxval=scale,
                        dtype=np.float32,
                    )
                )
            )
        return np.concatenate(parts).astype(np.float32)

    # -- compute -----------------------------------------------------------
    def apply(self, params, x, *, compute_dtype=COMPUTE_DTYPE):
        mats = self._split_weights(params)
        h = x.astype(compute_dtype)
        for i, w in enumerate(mats):
            wt = w.T.astype(compute_dtype)
            h = jnp.dot(h, wt, preferred_element_type=jnp.float32)
            act = (
                self.output_activation if i == len(mats) - 1 else self.activation
            )
            h = activation_fn(h, act).astype(compute_dtype)
        return h

    def hyperparams(self):
        return {
            "otype": "CutlassMLP",
            "activation": self.activation.value,
            "output_activation": self.output_activation.value,
            "n_neurons": self.n_neurons,
            "n_hidden_layers": self.n_hidden_layers,
        }


class FullyFusedMLP(CutlassMLP):
    """Width-restricted MLP; fused Triton kernels on a GPU (`mlp_route`)."""

    SUPPORTED_WIDTHS = (16, 32, 64, 128)

    def __init__(
        self,
        input_width: int,
        n_output_dims: int,
        n_neurons: int = 128,
        n_hidden_layers: int = 5,
        activation: Activation = Activation.ReLU,
        output_activation: Activation = Activation.NONE,
    ):
        if n_neurons not in self.SUPPORTED_WIDTHS:
            raise ValueError(
                f"FullyFusedMLP only supports widths {self.SUPPORTED_WIDTHS}; "
                f"got {n_neurons}. Use CutlassMLP instead."
            )
        if n_hidden_layers <= 0:
            # fully_fused_mlp.cu:650-652
            raise ValueError("FullyFusedMLP requires at least 1 hidden layer")
        super().__init__(
            input_width,
            n_output_dims,
            n_neurons,
            n_hidden_layers,
            activation,
            output_activation,
        )
        #: "triton" or "xla", fixed from the config and platform before any
        #: tracing
        self.route = mlp_route(self, jax.default_backend())

    def apply(self, params, x, *, compute_dtype=COMPUTE_DTYPE,
              second_order=False):
        # the fused kernels compute in bf16 and their custom_vjp backward is
        # not differentiable a second time; the XLA matmul chain does both
        if (
            self.route == "triton"
            and compute_dtype == jnp.bfloat16
            and not second_order
        ):
            return fused_mlp_apply(self, params, x)
        return super().apply(params, x, compute_dtype=compute_dtype)

    def hyperparams(self):
        hp = super().hyperparams()
        hp["otype"] = "FullyFusedMLP"
        return hp


def mlp_route(mlp, platform: str) -> str:
    """Which implementation a FullyFusedMLP runs on `platform` (a JAX
    backend name): "triton" for the fused Pallas kernels, "xla" for the
    matmul chain. The kernels compile only for a GPU and cover neither
    Sine nor hidden widths above 64 (`mlp_kernel.supports`)."""
    if platform != "gpu" or not fused_kernel_supports(mlp):
        return "xla"
    return "triton"
