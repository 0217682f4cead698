"""Grid encoding parity tests.

The key test re-implements the reference's per-thread indexing logic
(common_device.h:631-718, grid.h:48-212) as literal scalar numpy and checks
our vectorized uint32 jnp implementation against it, including the
wraparound-stride early-exit semantics and all three hash families.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tcnn_tpu.common import GridType, HashType, InterpolationType
from tcnn_tpu.ops.encodings.grid import GridEncoding, grid_resolution, grid_scale
from tcnn_tpu.registry import create_encoding

U32 = np.uint32
M32 = np.uint64(0xFFFFFFFF)


def _scalar_hash(cell, hash_type):
    primes = [1958374283, 2654435761, 805459861, 3674653429]
    if hash_type == HashType.CoherentPrime:
        primes = [1] + primes[1:]
    elif hash_type == HashType.ReversedPrime:
        primes = [2165219737, 1434869437, 2097192037, 3674653429, 805459861,
                  2654435761, 1958374283][: len(cell)]
    h = 0
    for c, p in zip(cell, primes):
        h ^= (int(c) * p) & 0xFFFFFFFF
    return h & 0xFFFFFFFF


def _scalar_grid_index(grid_type, hash_type, hashmap_size, resolution, cell):
    """Literal transcription of grid_index (common_device.h:690-707)."""
    stride = 1
    index = 0
    for dim in range(len(cell)):
        if stride > hashmap_size:
            break
        index = (index + int(cell[dim]) * stride) & 0xFFFFFFFF
        stride = (stride * resolution) & 0xFFFFFFFF
    if grid_type == GridType.Hash and hashmap_size < stride:
        index = _scalar_hash(cell, hash_type)
    return index % hashmap_size


@pytest.mark.parametrize("hash_type", [HashType.CoherentPrime, HashType.Prime, HashType.ReversedPrime])
@pytest.mark.parametrize("grid_type", [GridType.Hash, GridType.Dense, GridType.Tiled])
def test_grid_indices_match_scalar_reference(grid_type, hash_type):
    enc = GridEncoding(
        3,
        n_levels=6,
        n_features_per_level=2,
        log2_hashmap_size=9,
        base_resolution=4,
        per_level_scale=2.0,
        grid_type=grid_type,
        hash_type=hash_type,
    )
    rng = np.random.default_rng(0)
    cells = rng.integers(0, 1 << 20, size=(16, enc.n_levels, 4, 3)).astype(U32)
    ours = np.asarray(enc._grid_indices(jnp.asarray(cells)))
    for b in range(16):
        for lvl in range(enc.n_levels):
            res = int(enc._resolutions[lvl])
            size = int(enc._sizes[lvl])
            for c in range(4):
                expected = _scalar_grid_index(
                    grid_type, hash_type, size, res, cells[b, lvl, c]
                )
                assert ours[b, lvl, c] == expected, (b, lvl, c)


def test_offset_table_config_hash():
    """Offset table for data/config_hash.json (L16 F2 T2^15 base16 s1.5)."""
    enc = GridEncoding(
        2, n_levels=16, n_features_per_level=2, log2_hashmap_size=15,
        base_resolution=16, per_level_scale=1.5,
    )
    # independently recompute per grid.h:685-730
    offset = 0
    for lvl in range(16):
        s = grid_scale(lvl, math.log2(1.5), 16)
        res = grid_resolution(s)
        dense = res * res
        params = min(-(-dense // 8) * 8, 1 << 15)
        assert enc._offsets[lvl] == offset
        assert enc._sizes[lvl] == params
        offset += params
    assert enc.n_params == offset * 2


def test_forward_interpolates_linearly():
    """A dense 1-level grid must reproduce bilinear interpolation of its
    table values."""
    enc = GridEncoding(
        2, n_levels=1, n_features_per_level=2, base_resolution=4,
        per_level_scale=2.0, grid_type=GridType.Dense,
    )
    rng = np.random.default_rng(1)
    params = rng.normal(size=(enc.n_params,)).astype(np.float32)
    res = int(enc._resolutions[0])
    size = int(enc._sizes[0])
    table = params.reshape(size, 2)

    x = np.array([[0.3, 0.6]], np.float32)
    scale = float(enc._scales[0])
    y = np.asarray(enc.apply_unpadded(jnp.asarray(params), jnp.asarray(x),
                                      compute_dtype=jnp.float32))[0]

    # manual bilinear with the +0.5 stagger and dense index = x + y*res
    pos = x[0] * scale + 0.5
    cell = np.floor(pos).astype(int)
    w = pos - cell
    expected = np.zeros(2)
    for corner in range(4):
        bits = [(corner >> d) & 1 for d in range(2)]
        weight = np.prod([w[d] if bits[d] else 1 - w[d] for d in range(2)])
        idx = ((cell[0] + bits[0]) + (cell[1] + bits[1]) * res) % size
        expected += weight * table[idx]
    np.testing.assert_allclose(y, expected, rtol=1e-5)


@pytest.mark.parametrize("interp", [InterpolationType.Linear, InterpolationType.Smoothstep])
def test_input_gradients_finite_difference(interp):
    enc = GridEncoding(
        3, n_levels=4, n_features_per_level=2, log2_hashmap_size=10,
        base_resolution=4, per_level_scale=1.5, interpolation=interp,
    )
    params = jnp.asarray(
        np.random.default_rng(2).normal(size=(enc.n_params,)), jnp.float32
    )

    def f(x):
        return jnp.sum(enc.apply_unpadded(params, x, compute_dtype=jnp.float32) ** 2)

    # NOTE: points chosen away from cell boundaries of every level (linear
    # interpolation has gradient kinks there, where FD and one-sided autodiff
    # legitimately differ; e.g. 0.52*12.5+0.5 == 7.0 exactly).
    x0 = np.full((2, 3), 0.0, np.float64)
    x0[0] = [0.31, 0.47, 0.63]
    x0[1] = [0.11, 0.86, 0.53]
    g = np.asarray(jax.grad(f)(jnp.asarray(x0, jnp.float32)))
    eps = 1e-4
    for i in range(2):
        for j in range(3):
            xp, xm = x0.copy(), x0.copy()
            xp[i, j] += eps
            xm[i, j] -= eps
            fd = (float(f(jnp.asarray(xp, jnp.float32)))
                  - float(f(jnp.asarray(xm, jnp.float32)))) / (2 * eps)
            np.testing.assert_allclose(g[i, j], fd, rtol=5e-2, atol=5e-3)


def test_param_gradients_are_scatter_of_weights():
    """d(sum y)/d(table) puts each sample's interpolation weights onto the
    gathered rows (the deterministic analog of kernel_grid_backward's
    atomicAdd scatter, grid.h:214-320)."""
    enc = GridEncoding(
        2, n_levels=1, n_features_per_level=2, base_resolution=4,
        grid_type=GridType.Dense,
    )
    params = jnp.zeros((enc.n_params,), jnp.float32)
    x = jnp.asarray([[0.4, 0.2]], jnp.float32)

    g = jax.grad(
        lambda p: jnp.sum(enc.apply_unpadded(p, x, compute_dtype=jnp.float32))
    )(params)
    g = np.asarray(g)
    # gradient sums to 2 (one per feature; weights sum to 1 per feature)
    np.testing.assert_allclose(g.sum(), 2.0, rtol=1e-5)
    assert (g != 0).sum() == 8  # 4 corners x 2 features


def test_second_order_gradients_nonzero_smoothstep():
    """grad-of-grad flows (the reference needs dedicated bwd-bwd kernels,
    grid.h:902-1026; here it is plain autodiff)."""
    enc = GridEncoding(
        2, n_levels=2, n_features_per_level=2, base_resolution=4,
        grid_type=GridType.Dense, interpolation=InterpolationType.Smoothstep,
    )
    params = jnp.asarray(
        np.random.default_rng(3).normal(size=(enc.n_params,)), jnp.float32
    )
    x = jnp.asarray([[0.37, 0.51]], jnp.float32)

    def f(x):
        return jnp.sum(enc.apply_unpadded(params, x, compute_dtype=jnp.float32) ** 2)

    h = jax.hessian(f)(x)
    assert np.isfinite(np.asarray(h)).all()
    assert float(jnp.abs(jnp.asarray(h)).sum()) > 0


def test_second_order_param_grads_through_input_grad():
    """The gradcheck exercised by scripts/test_grid_bwdbwd.py: d/dparams of
    dL/dx must exist and be correct vs finite differences."""
    enc = GridEncoding(
        2, n_levels=2, n_features_per_level=1, base_resolution=4,
        grid_type=GridType.Dense, interpolation=InterpolationType.Smoothstep,
    )
    rng = np.random.default_rng(4)
    p0 = rng.normal(size=(enc.n_params,)).astype(np.float32)
    x = jnp.asarray([[0.42, 0.58]], jnp.float32)

    def dfdx_norm(p):
        g = jax.grad(
            lambda xx: jnp.sum(
                enc.apply_unpadded(p, xx, compute_dtype=jnp.float32) ** 2
            )
        )(x)
        return jnp.sum(g**2)

    gp = np.asarray(jax.grad(dfdx_norm)(jnp.asarray(p0)))
    eps = 1e-3
    # spot-check a few nonzero coordinates
    idxs = np.argsort(-np.abs(gp))[:5]
    for i in idxs:
        pp, pm = p0.copy(), p0.copy()
        pp[i] += eps
        pm[i] -= eps
        fd = (float(dfdx_norm(jnp.asarray(pp))) - float(dfdx_norm(jnp.asarray(pm)))) / (2 * eps)
        np.testing.assert_allclose(gp[i], fd, rtol=3e-2, atol=1e-3)


def test_max_level_zeroes_fine_levels():
    enc = GridEncoding(2, n_levels=4, n_features_per_level=2, base_resolution=4)
    params = jnp.asarray(
        np.random.default_rng(5).normal(size=(enc.n_params,)), jnp.float32
    )
    x = jnp.asarray([[0.3, 0.7]], jnp.float32)
    y = np.asarray(
        enc.apply_unpadded(params, x, compute_dtype=jnp.float32, max_level=0.5)
    )[0]
    # grid.h:69-75: level zeroed iff level >= max_level*L + 1e-3, so with
    # max_level=0.5 and L=4 levels 0..2 survive and level 3 is zeroed
    assert np.abs(y[:6]).sum() > 0
    np.testing.assert_allclose(y[6:], 0.0)


def test_tiled_grid_param_cap():
    enc = GridEncoding(
        3, n_levels=5, n_features_per_level=2, base_resolution=4,
        per_level_scale=2.0, grid_type=GridType.Tiled,
    )
    assert max(enc._sizes) <= 4**3


def test_config_factory_types():
    for otype, expected in [
        ("HashGrid", GridType.Hash),
        ("TiledGrid", GridType.Tiled),
        ("DenseGrid", GridType.Dense),
    ]:
        enc = create_encoding(3, {"otype": otype, "n_levels": 2,
                                  "base_resolution": 4})
        assert enc.grid_type == expected


def test_rng_hash_grid():
    """HashType.Rng: PCG32-advance hash (common_device.h:663-677), validated
    bit-exactly against a python-int PCG32 oracle inside the encoding."""
    from tcnn_tpu.ops.pcg32 import host_rng_hash
    from tcnn_tpu.common import HashType, GridType

    enc = GridEncoding(
        3,
        n_levels=4,
        n_features_per_level=2,
        log2_hashmap_size=8,
        base_resolution=4,
        per_level_scale=2.0,
        hash_type=HashType.Rng,
    )
    rng = np.random.default_rng(0)
    params = jnp.asarray(rng.uniform(-1, 1, enc.n_params), jnp.float32)
    x = jnp.asarray(rng.uniform(0, 1, (32, 3)), jnp.float32)
    y = enc.apply(params, x, compute_dtype=jnp.float32)
    assert y.shape == (32, 8)
    assert np.isfinite(np.asarray(y)).all()

    # cross-check the index math on the finest (hashed) level for one sample
    lvl = 3
    scale = float(enc._scales[lvl])
    size = int(enc._sizes[lvl])
    pos = np.asarray(x[0]) * scale + 0.5
    cell = np.floor(pos).astype(np.uint64)
    h = host_rng_hash(cell, 3) % size
    table = np.asarray(params).reshape(-1, 2)
    row = int(enc._offsets[lvl]) + int(h)
    # the corner-(0,0,0) feature contributes with weight prod(1 - fract)
    w = np.prod(1.0 - (pos - np.floor(pos)))
    # reconstruct full interpolation with the oracle for exactness
    out = np.zeros(2)
    for corner in range(8):
        bits = [(corner >> d) & 1 for d in range(3)]
        c = cell + np.asarray(bits, np.uint64)
        stride, idx, alive = 1, 0, True
        res = int(enc._resolutions[lvl])
        for d in range(3):
            if stride <= size:
                idx += int(c[d]) * stride
                stride = (stride * res) & 0xFFFFFFFF
        if size < stride:
            idx = host_rng_hash(c, 3)
        idx %= size
        cw = np.prod([(pos[d] - np.floor(pos[d])) if bits[d] else (1 - pos[d] + np.floor(pos[d])) for d in range(3)])
        out += cw * table[int(enc._offsets[lvl]) + idx]
    got = np.asarray(y[0, lvl * 2 : lvl * 2 + 2], np.float64)
    np.testing.assert_allclose(got, out, atol=1e-4)


def test_stochastic_interpolation_backward():
    """grid.h:284-299: forward is exact interpolation; the table-gradient
    scatter goes to ONE randomly chosen corner per (sample, level) with
    weight 1. Check: forward matches the deterministic encoding; per-level
    gradient mass equals sum(|dL/dy|) routed to single rows; gradients are
    deterministic across calls; expectation over many samples approximates
    the exact gradient."""
    from tcnn_tpu.common import GridType

    kw = dict(
        n_levels=3,
        n_features_per_level=2,
        log2_hashmap_size=8,
        base_resolution=4,
        per_level_scale=1.7,
    )
    enc_s = GridEncoding(2, stochastic_interpolation=True, **kw)
    enc_d = GridEncoding(2, stochastic_interpolation=False, **kw)
    rng = np.random.default_rng(0)
    params = jnp.asarray(rng.uniform(-1, 1, enc_s.n_params), jnp.float32)
    x = jnp.asarray(rng.uniform(0.1, 0.9, (64, 2)), jnp.float32)

    y_s = enc_s.apply(params, x, compute_dtype=jnp.float32)
    y_d = enc_d.apply(params, x, compute_dtype=jnp.float32)
    np.testing.assert_allclose(np.asarray(y_s), np.asarray(y_d), atol=1e-6)

    def loss(p, enc):
        return jnp.sum(enc.apply(p, x, compute_dtype=jnp.float32))

    g1 = np.asarray(jax.grad(loss)(params, enc_s))
    g2 = np.asarray(jax.grad(loss)(params, enc_s))
    np.testing.assert_array_equal(g1, g2)  # deterministic

    # gradient mass per level: with dL/dy = 1 everywhere, each (sample,
    # level) contributes exactly 1 per feature -> total mass = B per
    # (level, feature), same as the exact path's weights summing to 1
    gd = np.asarray(jax.grad(loss)(params, enc_d))
    F = enc_s.n_features_per_level
    for lvl in range(3):
        off = int(enc_s._offsets[lvl]) * F
        size = int(enc_s._sizes[lvl]) * F
        np.testing.assert_allclose(
            g1[off : off + size].sum(), gd[off : off + size].sum(), rtol=1e-4
        )
    # stochastic rows hold integer counts (weight 1 scatters of dL/dy = 1)
    assert np.allclose(g1, np.round(g1), atol=1e-4)


def test_stochastic_max_level_masks_gradients():
    """With stochastic_interpolation + max_level, the
    clamped levels must receive ZERO table gradients (the reference kernel
    early-returns for level > max_level, grid.h:236-243) - the stochastic
    custom_vjp must mask the cotangent itself."""
    kw = dict(
        n_levels=4,
        n_features_per_level=2,
        log2_hashmap_size=8,
        base_resolution=4,
        per_level_scale=1.7,
    )
    enc = GridEncoding(2, stochastic_interpolation=True, **kw)
    rng = np.random.default_rng(1)
    params = jnp.asarray(rng.uniform(-1, 1, enc.n_params), jnp.float32)
    x = jnp.asarray(rng.uniform(0.1, 0.9, (32, 2)), jnp.float32)

    def loss(p):
        # max_level=0.5, L=4: levels 0..2 survive, level 3 clamped
        return jnp.sum(
            enc.apply_unpadded(p, x, compute_dtype=jnp.float32, max_level=0.5)
        )

    g = np.asarray(jax.grad(loss)(params))
    F = enc.n_features_per_level
    off3 = int(enc._offsets[3]) * F
    assert np.all(g[off3:] == 0.0), "clamped level 3 must get zero grads"
    # surviving levels still receive gradient mass (B per level-feature)
    off2 = int(enc._offsets[2]) * F
    assert g[off2:off3].sum() > 0


def test_stochastic_corners_consistent_across_paths():
    """The stochastic backward scatters each (sample, level) gradient into
    the corner chosen by the shared `stochastic_uniforms` draws
    (grid.h:287: corner bit d = u < w_d): the rows it picks equal the rows
    derived in numpy from the same draws, so any path that uses the helper
    over the true batch chooses the same corners."""
    from tcnn_tpu.ops.encodings.grid import stochastic_uniforms

    enc = GridEncoding(2, n_levels=5, n_features_per_level=2,
                       log2_hashmap_size=8, base_resolution=4,
                       per_level_scale=1.7, stochastic_interpolation=True)
    rng = np.random.default_rng(3)
    x = rng.uniform(0.05, 0.95, (37, 2)).astype(np.float32)
    u = np.asarray(stochastic_uniforms(37, 5))
    np.testing.assert_array_equal(u, np.asarray(stochastic_uniforms(37, 5)))
    assert np.all((u >= 0) & (u < 1))
    rows = np.asarray(enc._stochastic_corner_rows(jnp.asarray(x)))
    for lvl in range(5):
        pos = x * enc._scales[lvl] + np.float32(0.5)
        cell = np.floor(pos)
        bits = (u[:, lvl, None] < (pos - cell)).astype(np.uint32)
        chosen = (cell.astype(np.uint32) + bits)[:, None, None, :]
        want = np.asarray(enc._grid_indices(jnp.asarray(
            np.broadcast_to(chosen, (37, 5, 1, 2)).copy())))[:, lvl, 0]
        np.testing.assert_array_equal(
            rows[:, lvl], int(enc._offsets[lvl]) + want)
