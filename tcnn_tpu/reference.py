"""Plain numpy references for the hot path.

Written from the reference's per-thread semantics (grid.h:48-212,
common_device.h:631-718, fully_fused_mlp.cu:150-632) independently of the
JAX code they check, in float64 with vectorized numpy: the tests compare
the library against them at small shapes, and `chip_smoke.py` at the
widths and batch of a real run.
"""

from __future__ import annotations

import math

import numpy as np

from .common import Activation, GridType, HashType, InterpolationType, K_ACT

_PRIMES = (1958374283, 2654435761, 805459861, 3674653429, 2097192037,
           1434869437, 2165219737)
_M32 = 0xFFFFFFFF


def _hash_factors(hash_type: HashType, n_dims: int):
    if hash_type == HashType.Prime:
        f = _PRIMES
    elif hash_type == HashType.CoherentPrime:
        f = (1,) + _PRIMES[1:]
    elif hash_type == HashType.ReversedPrime:
        f = _PRIMES[::-1]
    else:
        raise ValueError(f"no numpy reference for hash {hash_type}")
    return f[:n_dims]


def grid_levels(enc):
    """Per level (offset, size, resolution, scale) in table rows, from the
    encoding's hyperparameters (grid.h:685-730).

    The resolution is ceil of the scale taken in float64, as GridEncoding
    does; tiny-cuda-nn takes it in float32 (exp2f), which differs where the
    float64 scale lands just above an integer (ROADMAP.md)."""
    d = enc.n_dims_to_encode
    log2_scale = math.log2(enc.per_level_scale)
    levels, offset = [], 0
    for lvl in range(enc.n_levels):
        scale64 = np.exp2(lvl * log2_scale) * enc.base_resolution - 1.0
        scale = np.float32(scale64)
        res = int(math.ceil(scale64)) + 1
        size = min(res**d, 2**31)
        size = -(-size // 8) * 8
        if enc.grid_type == GridType.Tiled:
            size = min(size, enc.base_resolution**d)
        elif enc.grid_type == GridType.Hash:
            size = min(size, 1 << enc.log2_hashmap_size)
        levels.append((offset, size, res, scale))
        offset += size
    return levels


def _grid_index(cells, size, res, grid_type, hash_type):
    """cells int64 [N, D] (uint32 values) -> row within the level
    (common_device.h:690-707)."""
    index = np.zeros(cells.shape[0], np.int64)
    stride = 1
    for dim in range(cells.shape[1]):
        if stride > size:
            break
        index = (index + cells[:, dim] * stride) & _M32
        stride = (stride * res) & _M32
    if grid_type == GridType.Hash and size < stride:
        index = np.zeros_like(index)
        for dim, p in enumerate(_hash_factors(hash_type, cells.shape[1])):
            index ^= (cells[:, dim] * p) & _M32
    return index % size


def _grid_corners(enc, x, fma):
    """Yields (level, rows [B], weights [B]) for every corner of every
    level that contributes to the encoding of x [B, D]."""
    x = np.asarray(x, np.float32)
    d = enc.n_dims_to_encode
    for lvl, (offset, size, res, scale) in enumerate(grid_levels(enc)):
        if fma:
            # fmaf(scale, x, 0.5f) (pos_fract, common_device.h:826-867):
            # one rounding; the float64 product of two floats is exact
            pos = (x.astype(np.float64) * float(scale) + 0.5).astype(
                np.float32)
        else:
            pos = x * scale + np.float32(0.5)
        cell_f = np.floor(pos)
        frac = (pos - cell_f).astype(np.float64)
        cells = cell_f.astype(np.int64) & _M32
        if enc.interpolation == InterpolationType.Nearest:
            rows = _grid_index(cells, size, res, enc.grid_type, enc.hash_type)
            yield lvl, offset + rows, np.ones(x.shape[0])
            continue
        w = frac
        if enc.interpolation == InterpolationType.Smoothstep:
            w = frac * frac * (3.0 - 2.0 * frac)
        for corner in range(1 << d):
            bits = np.array([(corner >> i) & 1 for i in range(d)])
            rows = _grid_index(
                (cells + bits) & _M32, size, res, enc.grid_type, enc.hash_type
            )
            weight = np.prod(np.where(bits == 1, w, 1.0 - w), axis=1)
            yield lvl, offset + rows, weight


def grid_encode(enc, params, x, fma=True):
    """GridEncoding forward: x [B, D] -> [B, n_levels * F] (float64).

    The cell position x * scale + 0.5 is rounded to float32 once, as
    tiny-cuda-nn's fmaf does (fma=True), or after the product and again
    after the sum (fma=False). XLA may compile either: one float32 ulp of
    the position moves the interpolation weights by up to 2^-24 * scale."""
    F = enc.n_features_per_level
    table = np.asarray(params, np.float64).reshape(-1, F)
    out = np.zeros((np.shape(x)[0], enc.n_levels, F))
    for lvl, rows, weight in _grid_corners(enc, x, fma):
        out[:, lvl] += weight[:, None] * table[rows]
    return out.reshape(out.shape[0], -1)


def grid_table_grad(enc, x, dy, fma=True):
    """dL/dtable for the cotangent dy [B, n_levels * F], flat like params
    (`fma` as for grid_encode)."""
    F = enc.n_features_per_level
    dy = np.asarray(dy, np.float64).reshape(-1, enc.n_levels, F)
    total = sum(size for _, size, _, _ in grid_levels(enc))
    grad = np.zeros((total, F))
    for lvl, rows, weight in _grid_corners(enc, x, fma):
        np.add.at(grad, rows, weight[:, None] * dy[:, lvl])
    return grad.reshape(-1)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def activation(z, act: Activation):
    if act == Activation.NONE:
        return z
    if act == Activation.ReLU:
        return np.maximum(z, 0.0)
    if act == Activation.LeakyReLU:
        return np.where(z > 0, z, 0.01 * z)
    if act == Activation.Exponential:
        return np.exp(z)
    if act == Activation.Sine:
        return np.sin(z)
    if act == Activation.Sigmoid:
        return 1.0 / (1.0 + np.exp(-z))
    if act == Activation.Squareplus:
        zk = z * K_ACT
        return 0.5 * (zk + np.sqrt(zk * zk + 4.0)) / K_ACT
    if act == Activation.Softplus:
        return np.logaddexp(0.0, z * K_ACT) / K_ACT
    if act == Activation.Tanh:
        return np.tanh(z)
    raise ValueError(act)


def activation_grad(z, act: Activation):
    """d activation / dz at the pre-activation z."""
    if act == Activation.NONE:
        return np.ones_like(z)
    if act == Activation.ReLU:
        return (z > 0).astype(z.dtype)
    if act == Activation.LeakyReLU:
        return np.where(z > 0, 1.0, 0.01)
    if act == Activation.Exponential:
        return np.exp(z)
    if act == Activation.Sine:
        return np.cos(z)
    if act == Activation.Sigmoid:
        s = 1.0 / (1.0 + np.exp(-z))
        return s * (1.0 - s)
    if act == Activation.Squareplus:
        zk = z * K_ACT
        return 0.5 * (1.0 + zk / np.sqrt(zk * zk + 4.0))
    if act == Activation.Softplus:
        return 1.0 / (1.0 + np.exp(-z * K_ACT))
    if act == Activation.Tanh:
        return 1.0 - np.tanh(z) ** 2
    raise ValueError(act)


def mlp_weights(mlp, params):
    """Flat params -> [W_i of shape (fan_out, fan_in)] (float64)."""
    params = np.asarray(params, np.float64)
    mats, off = [], 0
    for r, c in mlp.layer_sizes():
        mats.append(params[off : off + r * c].reshape(r, c))
        off += r * c
    return mats


def mlp_forward_backward(mlp, params, x, dy):
    """(y, dL/dparams, dL/dx) of y = mlp(x) for the cotangent dy, float64."""
    mats = mlp_weights(mlp, params)
    acts = [mlp.activation] * (len(mats) - 1) + [mlp.output_activation]
    hs, zs = [np.asarray(x, np.float64)], []
    for w, act in zip(mats, acts):
        zs.append(hs[-1] @ w.T)
        hs.append(activation(zs[-1], act))
    g = np.asarray(dy, np.float64)
    grads = [None] * len(mats)
    for i in reversed(range(len(mats))):
        g = g * activation_grad(zs[i], acts[i])
        grads[i] = (g.T @ hs[i]).reshape(-1)
        g = g @ mats[i]
    return hs[-1], np.concatenate(grads), g
