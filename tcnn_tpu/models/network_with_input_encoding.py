"""Encoding -> Network composition.

Mirror of NetworkWithInputEncoding
(/root/reference/include/tiny-cuda-nn/network_with_input_encoding.h:41-192):
the encoding's padded output width is aligned to the network's minimum
alignment (:46-53), and the flat parameter vector is laid out
[network params, encoding params] (:115-130). The intermediate
`network_input` matrix of the reference (:70-81) is just a value flowing
between two jnp calls here - XLA fuses or materializes it as it sees fit.
"""

from __future__ import annotations

import inspect

import jax
import numpy as np

from ..common import COMPUTE_DTYPE
from ..ops.encodings.base import Encoding
from .base import Network


class NetworkWithInputEncoding(Network):
    def __init__(self, encoding: Encoding, network_factory):
        """`network_factory(input_width) -> Network` defers network creation
        until the encoding's padded width is known (mirrors the construction
        order in network_with_input_encoding.h:55 + network.cu:98)."""
        self.encoding = encoding
        network = network_factory(encoding)
        # align encoding output to the network's demands
        encoding.set_alignment(network.minimum_alignment)
        self.network = network_factory(encoding)
        super().__init__(encoding.n_dims_to_encode, self.network.n_output_dims)

    @property
    def n_input_dims(self) -> int:
        return self.encoding.n_dims_to_encode

    @property
    def padded_output_width(self) -> int:
        return self.network.padded_output_width

    @property
    def n_params(self) -> int:
        return self.network.n_params + self.encoding.n_params

    def layer_sizes(self):
        return self.network.layer_sizes() + self.encoding.layer_sizes()

    def split_params(self, params):
        n_net = self.network.n_params
        return params[:n_net], params[n_net:]

    def init_params(self, key) -> np.ndarray:
        k_net, k_enc = jax.random.split(key)
        return np.concatenate(
            [self.network.init_params(k_net), self.encoding.init_params(k_enc)]
        ).astype(np.float32)

    def apply(
        self,
        params,
        x,
        *,
        compute_dtype=COMPUTE_DTYPE,
        max_level=None,
        prepare_input_gradients=False,
    ):
        """`prepare_input_gradients` mirrors the reference flag
        (network_with_input_encoding.h:70-81): leave False unless gradients
        w.r.t. `x` are needed - it lets the encoding skip its input-gradient
        work in the backward."""
        net_p, enc_p = self.split_params(params)
        kwargs = {}
        if max_level is not None:
            kwargs["max_level"] = max_level
        if getattr(self.encoding, "supports_input_grad_opt", False):
            kwargs["needs_input_grad"] = prepare_input_gradients
        enc_out = self.encoding.apply(
            enc_p, x, compute_dtype=compute_dtype, **kwargs
        )
        net_kwargs = {}
        if prepare_input_gradients:
            # input-gradient callers are the second-order-prone ones
            # (eikonal etc.); the fused MLP kernel differentiates once
            # only, so give them the arbitrary-order XLA matmul path
            if "second_order" in inspect.signature(
                self.network.apply
            ).parameters:
                net_kwargs["second_order"] = True
        return self.network.apply(
            net_p, enc_out, compute_dtype=compute_dtype, **net_kwargs
        )

    def hyperparams(self):
        return {
            "otype": "NetworkWithInputEncoding",
            "encoding": self.encoding.hyperparams(),
            "network": self.network.hyperparams(),
        }
