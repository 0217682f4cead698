"""Fully fused MLP kernels for NVIDIA GPUs (Pallas, Triton route).

The GPU design of kernel_mlp_fused / kernel_mlp_fused_backward
(src/fully_fused_mlp.cu:150-632). Every program loads all layer weights
once, walks several row tiles of the batch, and chains
matmul -> activation across the layers of each tile without writing a
hidden activation to device memory:

  - forward writes only y;
  - backward recomputes the forward chain of its tile, runs the dgrad chain
    with activation transfer from post-activation values (the form the
    reference's backward uses), writes dL/dx and accumulates each layer's
    weight gradient in fp32 over its tiles. Each program writes its own
    partial sum, [n_programs, fan_in, fan_out] per layer, and one XLA
    reduction adds them up. There are no atomics, so the result is
    deterministic;
  - Triton's blocks are powers of two, so the input width is padded with
    zero columns (and zero weight rows) and the output width with zero
    weight columns; the batch is padded to whole tiles.

Not covered (`supports`): Sine, whose derivative needs the pre-activation
(the reference's fused kernel rejects it too, fully_fused_mlp.cu:681-705),
and hidden widths above 64, whose on-chip state outgrows an SM. The
backward is not differentiable again. `FullyFusedMLP` routes those cases
and second-order callers to the XLA chain.

The public entry is `fused_mlp_apply(mlp, params, x)`, differentiable once
via custom_vjp in both the parameters and x (the MLP sits above the
encoding, so its dL/dx feeds the encoding backward).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ...common import Activation
from ..activations import activation_bwd_out, activation_fn

#: rows per tile: the reference's 128-row chunk (fully_fused_mlp.cu:499)
BLOCK_ROWS = 128
#: most programs per launch; each program walks ceil(tiles / programs)
#: tiles, so weights are loaded and weight-gradient partials written this
#: many times per call at most
MAX_PROGRAMS = 256
COMPILER_PARAMS = plgpu.CompilerParams(num_warps=4, num_stages=2)
#: widest hidden layer the kernel takes: the backward keeps every layer's
#: fp32 weight-gradient accumulator and every hidden activation of its tile
#: on chip, which at width 128 outgrows the registers and shared memory of
#: a Hopper SM (measured on an H200: 128x5 asks for 256-396 KiB of the
#: 227 KiB of shared memory a block may use)
MAX_WIDTH = 64
#: most bytes of (padded, bf16) weights a program loads and keeps on chip
MAX_WEIGHT_BYTES = 128 * 1024


def supports(mlp) -> bool:
    """Whether the kernels cover `mlp`: no Sine, hidden width at most
    MAX_WIDTH, and weights that fit on chip."""
    n_w = mlp.n_hidden_layers + 1
    weight_bytes = 2 * (
        _pow2(mlp.input_width) * mlp.n_neurons
        + (n_w - 2) * mlp.n_neurons * mlp.n_neurons
        + mlp.n_neurons * _pow2(mlp.padded_output_width)
    )
    return (
        Activation.Sine not in (mlp.activation, mlp.output_activation)
        and mlp.n_neurons <= MAX_WIDTH
        and weight_bytes <= MAX_WEIGHT_BYTES
    )


def _pow2(n: int) -> int:
    return max(16, 1 << (int(n) - 1).bit_length())


def _layer_acts(mlp):
    n_w = mlp.n_hidden_layers + 1
    return tuple(
        mlp.output_activation if i == n_w - 1 else mlp.activation
        for i in range(n_w)
    )


def _weights_t(mlp, params):
    """flat fp32 params -> tuple of TRANSPOSED bf16 weights [fan_in, fan_out],
    the first padded to a power-of-two fan_in and the last to a
    power-of-two fan_out with zeros."""
    mats = []
    off = 0
    sizes = mlp.layer_sizes()
    for i, (r, c) in enumerate(sizes):
        w = params[off : off + r * c].reshape(r, c).T
        off += r * c
        pad_in = _pow2(c) - c if i == 0 else 0
        pad_out = _pow2(r) - r if i == len(sizes) - 1 else 0
        mats.append(jnp.pad(w, ((0, pad_in), (0, pad_out))).astype(jnp.bfloat16))
    return tuple(mats)


def _grid(n_rows: int):
    """(n_programs, tiles_per_program, n_tiles) for a padded batch."""
    n_tiles = n_rows // BLOCK_ROWS
    tiles = -(-n_tiles // MAX_PROGRAMS)
    return -(-n_tiles // tiles), tiles, n_tiles


def _chain(h, wts, acts, keep):
    hs = [h]
    for w, act in zip(wts, acts):
        h = activation_fn(pl.dot(h, w), act).astype(jnp.bfloat16)
        if keep:
            hs.append(h)
    return h, hs


def _tile_loop(tiles, n_tiles, body, init):
    first = pl.program_id(0) * tiles
    count = jnp.minimum(tiles, n_tiles - first)
    return jax.lax.fori_loop(
        0, count,
        lambda t, c: body(pl.ds((first + t) * BLOCK_ROWS, BLOCK_ROWS), c),
        init,
    )


def _fwd_kernel(x_ref, *refs, acts, tiles, n_tiles):
    *w_refs, y_ref = refs
    wts = [w[...] for w in w_refs]

    def body(rows, carry):
        y, _ = _chain(x_ref[rows, :], wts, acts, keep=False)
        y_ref[rows, :] = y
        return carry

    _tile_loop(tiles, n_tiles, body, 0)


def _bwd_kernel(x_ref, gy_ref, *refs, acts, tiles, n_tiles):
    n_w = len(acts)
    w_refs, gw_refs, gx_ref = refs[:n_w], refs[n_w : 2 * n_w], refs[2 * n_w]
    wts = [w[...] for w in w_refs]

    def body(rows, accs):
        _, hs = _chain(x_ref[rows, :], wts, acts, keep=True)
        g = gy_ref[rows, :].astype(jnp.float32)
        accs = list(accs)
        for i in reversed(range(n_w)):
            g = activation_bwd_out(g, hs[i + 1].astype(jnp.float32), acts[i])
            gb = g.astype(jnp.bfloat16)
            # wgrad: dL/dWt[in, out] = sum_n h[n, in] g[n, out]
            accs[i] = accs[i] + pl.dot(hs[i], gb, trans_a=True)
            # dgrad: g @ Wt^T
            g = pl.dot(gb, wts[i], trans_b=True)
        gx_ref[rows, :] = g.astype(gx_ref.dtype)
        return tuple(accs)

    init = tuple(jnp.zeros(w.shape, jnp.float32) for w in wts)
    for gw, acc in zip(gw_refs, _tile_loop(tiles, n_tiles, body, init)):
        gw[...] = acc


def _whole(a):
    return pl.BlockSpec(a.shape, lambda i: (0,) * a.ndim)


def _fwd_call(acts, wts, x, interpret):
    n_prog, tiles, n_tiles = _grid(x.shape[0])
    return pl.pallas_call(
        functools.partial(_fwd_kernel, acts=acts, tiles=tiles, n_tiles=n_tiles),
        grid=(n_prog,),
        in_specs=[_whole(x)] + [_whole(w) for w in wts],
        out_specs=pl.BlockSpec(
            (x.shape[0], wts[-1].shape[1]), lambda i: (0, 0)
        ),
        out_shape=jax.ShapeDtypeStruct(
            (x.shape[0], wts[-1].shape[1]), jnp.bfloat16
        ),
        backend="triton",
        compiler_params=COMPILER_PARAMS,
        interpret=interpret,
        name="ffmlp_fwd",
    )(x, *wts)


def _bwd_call(acts, wts, x, gy, interpret):
    n_prog, tiles, n_tiles = _grid(x.shape[0])
    gw_specs = [
        pl.BlockSpec((None,) + w.shape, lambda i: (i, 0, 0)) for w in wts
    ]
    return pl.pallas_call(
        functools.partial(_bwd_kernel, acts=acts, tiles=tiles, n_tiles=n_tiles),
        grid=(n_prog,),
        in_specs=[_whole(x), _whole(gy)] + [_whole(w) for w in wts],
        out_specs=gw_specs + [_whole(x)],
        out_shape=[
            jax.ShapeDtypeStruct((n_prog,) + w.shape, jnp.float32) for w in wts
        ]
        + [jax.ShapeDtypeStruct(x.shape, jnp.bfloat16)],
        backend="triton",
        compiler_params=COMPILER_PARAMS,
        interpret=interpret,
        name="ffmlp_bwd",
    )(x, gy, *wts)


@functools.partial(jax.custom_vjp, nondiff_argnums=(0, 3))
def _fused_mlp(mlp, params, x, interpret):
    return _fwd_call(_layer_acts(mlp), _weights_t(mlp, params), x, interpret)


def _fused_mlp_fwd(mlp, params, x, interpret):
    return _fused_mlp(mlp, params, x, interpret), (params, x)


def _fused_mlp_bwd(mlp, interpret, res, gy):
    params, x = res
    *partials, gx = _bwd_call(
        _layer_acts(mlp), _weights_t(mlp, params), x,
        gy.astype(jnp.bfloat16), interpret,
    )
    grads = []
    for (r, c), p in zip(mlp.layer_sizes(), partials):
        grads.append(jnp.sum(p, axis=0)[:c, :r].T.reshape(-1))
    return jnp.concatenate(grads).astype(params.dtype), gx.astype(x.dtype)


_fused_mlp.defvjp(_fused_mlp_fwd, _fused_mlp_bwd)


def fused_mlp_apply(mlp, params, x, *, interpret=False):
    """y = mlp(x) through the fused kernels: bf16 [B, padded_output_width].

    `interpret=True` runs the kernels in the Pallas interpreter (tests on
    a host without a GPU)."""
    if not supports(mlp):
        raise ValueError(
            "the fused MLP kernels do not cover this MLP (Sine, width > "
            f"{MAX_WIDTH} or weights beyond {MAX_WEIGHT_BYTES} bytes)"
        )
    b, w_in = x.shape
    rows = -(-b // BLOCK_ROWS) * BLOCK_ROWS
    x = jnp.pad(x.astype(jnp.bfloat16), ((0, rows - b), (0, _pow2(w_in) - w_in)))
    y = _fused_mlp(mlp, params.astype(jnp.float32), x, interpret)
    return y[:b, : mlp.padded_output_width]
