"""GridEncoding's XLA path against the independent float64 numpy reference
(tcnn_tpu/reference.py): forward pass and table gradient over input
dimensions, grid types, hash functions, interpolations and feature counts,
with inputs that leave [0, 1] (the uint32 wraparound of grid.h)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tcnn_tpu import reference
from tcnn_tpu.common import GridType, HashType, InterpolationType
from tcnn_tpu.ops.encodings.grid import GridEncoding

TOL = 1e-5


@functools.lru_cache(maxsize=None)
def _errors(d, grid_type, interp, f, hash_type):
    enc = GridEncoding(
        d, n_levels=4, n_features_per_level=f, log2_hashmap_size=8,
        base_resolution=4, per_level_scale=1.7, grid_type=grid_type,
        hash_type=hash_type, interpolation=interp,
    )
    rng = np.random.default_rng(d * 7 + f)
    params = rng.uniform(-1.0, 1.0, enc.n_params).astype(np.float32)
    x = rng.uniform(-0.2, 1.2, (65, d)).astype(np.float32)
    dy = rng.normal(size=(65, enc.n_output_dims)).astype(np.float32)

    def apply(p):
        return enc.apply_unpadded(p, jnp.asarray(x), compute_dtype=jnp.float32)

    y = np.asarray(apply(jnp.asarray(params)))
    g = np.asarray(jax.grad(lambda p: jnp.sum(apply(p) * dy))(
        jnp.asarray(params)))
    y_r = reference.grid_encode(enc, params, x)
    g_r = reference.grid_table_grad(enc, x, dy)
    assert y.shape == y_r.shape and g.shape == g_r.shape
    return (
        float(np.abs(y - y_r).max() / np.abs(y_r).max()),
        float(np.linalg.norm(g - g_r) / np.linalg.norm(g_r)),
    )


GRID_TYPES = [GridType.Hash, GridType.Dense, GridType.Tiled]
INTERPS = [InterpolationType.Linear, InterpolationType.Smoothstep,
           InterpolationType.Nearest]


@pytest.mark.parametrize("interp", INTERPS, ids=lambda i: i.value)
@pytest.mark.parametrize("grid_type", GRID_TYPES, ids=lambda g: g.value)
@pytest.mark.parametrize("d", [2, 3, 4])
def test_grid_forward_matches_reference(d, grid_type, interp):
    fwd, _ = _errors(d, grid_type, interp, 2, HashType.CoherentPrime)
    assert fwd < TOL


@pytest.mark.parametrize("interp", INTERPS, ids=lambda i: i.value)
@pytest.mark.parametrize("grid_type", GRID_TYPES, ids=lambda g: g.value)
@pytest.mark.parametrize("d", [2, 3, 4])
def test_grid_table_gradient_matches_reference(d, grid_type, interp):
    _, grad = _errors(d, grid_type, interp, 2, HashType.CoherentPrime)
    assert grad < TOL


@pytest.mark.parametrize(
    "hash_type", [HashType.Prime, HashType.CoherentPrime,
                  HashType.ReversedPrime], ids=lambda h: h.value)
@pytest.mark.parametrize("f", [1, 2, 4, 8])
def test_grid_features_and_hashes_match_reference(f, hash_type):
    fwd, grad = _errors(3, GridType.Hash, InterpolationType.Linear, f,
                        hash_type)
    assert fwd < TOL and grad < TOL


def test_reference_level_layout_matches_encoding():
    enc = GridEncoding(2, n_levels=16, n_features_per_level=2,
                       log2_hashmap_size=15, base_resolution=16,
                       per_level_scale=1.5)
    levels = reference.grid_levels(enc)
    assert [lv[0] for lv in levels] == [int(o) for o in enc._offsets]
    assert [lv[1] for lv in levels] == [int(s) for s in enc._sizes]
    assert sum(lv[1] for lv in levels) * 2 == enc.n_params
