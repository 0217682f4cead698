"""PPNG1/2/3 parity tests.

Reference semantics re-derived from ppng_1.h / ppng_2.h / ppng_3.h /
interp.h. Each encoding is checked against an independently written
scalar numpy oracle that follows the CUDA kernels' loop structure
(per-sample, per-frequency, per-phase), plus shape/param-count contracts,
autodiff gradients vs finite differences, and factory dispatch rules.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tcnn_tpu.ops.encodings.ppng import (
    PPNG1Encoding,
    PPNG2Encoding,
    PPNG3Encoding,
)
from tcnn_tpu.registry import create_encoding

F32 = jnp.float32


def _sc(x, F, lo, hi, Q):
    """Per-sample quantized coords: returns (p0, p1, w) arrays [F, 2, D]."""
    D = len(x)
    p0 = np.zeros((F, 2, D), np.int64)
    p1 = np.zeros((F, 2, D), np.int64)
    w = np.zeros((F, 2, D), np.float64)
    for f in range(F):
        base = f * (hi - lo) / (F - 1) + lo if F > 1 else lo
        freq = 2.0**base * 3.1415926535
        for s in range(2):
            for i in range(D):
                sc = math.sin(freq * (x[i] - 0.5) + s * math.pi / 2)
                p = (sc + 1) * 0.5 * (Q - 1)
                a = min(max(math.floor(p), 0), Q - 1)
                b = max(min(math.ceil(p), Q - 1), 0)
                p0[f, s, i] = a
                p1[f, s, i] = b
                w[f, s, i] = p - a
    return p0, p1, w


def _oracle_ppng1(tbl, x, Q, lo, hi):
    """tbl [F,2,D,C,Q,R]; x [D] -> out [F*2*C]."""
    F, _, D, C, _, R = tbl.shape
    p0, p1, w = _sc(x, F, lo, hi, Q)
    out = np.zeros((F, 2, C))
    for f in range(F):
        for s in range(2):
            for c in range(C):
                fs = 0.0
                for r in range(R):
                    prod = 1.0
                    for i in range(D):
                        f0 = tbl[f, s, i, c, p0[f, s, i], r]
                        f1 = tbl[f, s, i, c, p1[f, s, i], r]
                        wi = w[f, s, i]
                        prod *= wi * f1 + (1 - wi) * f0
                    fs += prod
                out[f, s, c] = fs
    return out.reshape(-1)


def _oracle_ppng2(tbl, x, Q, lo, hi):
    """tbl [F,2,3,C,Q,Q,R]; x [3] -> out [F*2*C]."""
    F, _, _, C, _, _, R = tbl.shape
    p0, p1, w = _sc(x, F, lo, hi, Q)
    out = np.zeros((F, 2, C))
    for f in range(F):
        for s in range(2):
            pp = [(p0[f, s, i], p1[f, s, i]) for i in range(3)]
            ww = w[f, s]
            for c in range(C):
                fs = 0.0
                for r in range(R):
                    for a in (0, 1):
                        for b in (0, 1):
                            for z in (0, 1):
                                wt = (
                                    (ww[0] if a else 1 - ww[0])
                                    * (ww[1] if b else 1 - ww[1])
                                    * (ww[2] if z else 1 - ww[2])
                                )
                                fx = tbl[f, s, 0, c, pp[2][z], pp[1][b], r]
                                fy = tbl[f, s, 1, c, pp[2][z], pp[0][a], r]
                                fz = tbl[f, s, 2, c, pp[1][b], pp[0][a], r]
                                fs += wt * fx * fy * fz
                out[f, s, c] = fs
    return out.reshape(-1)


def _oracle_ppng3(flat, x, Q, lo, hi, C):
    """flat [F,2,Q^D*C]; x [D] -> out [F*2*C]. Flat index sum_i p_i Q^i."""
    F = flat.shape[0]
    D = len(x)
    p0, p1, w = _sc(x, F, lo, hi, Q)
    out = np.zeros((F, 2, C))
    for f in range(F):
        for s in range(2):
            for corner in range(1 << D):
                offset = 0
                weight = 1.0
                for i in range(D):
                    inv_i = D - i - 1
                    bit = (corner >> inv_i) & 1
                    pi = p1[f, s, i] if bit else p0[f, s, i]
                    offset += pi * Q**i
                    weight *= w[f, s, i] if bit else 1 - w[f, s, i]
                for c in range(C):
                    out[f, s, c] += flat[f, s, offset * C + c] * weight
    return out.reshape(-1)


@pytest.mark.parametrize("rank", [2, 4])
def test_ppng1_matches_oracle(rank):
    enc = PPNG1Encoding(3, n_quants=9, n_frequencies=3, n_features=2, rank=rank)
    rng = np.random.default_rng(0)
    params = rng.uniform(-0.7, 0.7, enc.n_params).astype(np.float32)
    x = rng.uniform(0, 1, (5, 3)).astype(np.float32)
    y = np.asarray(enc.apply(jnp.asarray(params), jnp.asarray(x), compute_dtype=F32))
    tbl = params.reshape(3, 2, 3, 2, 9, rank)
    for b in range(5):
        exp = _oracle_ppng1(tbl, x[b], 9, 0, 6)
        np.testing.assert_allclose(y[b], exp, rtol=1e-4, atol=1e-5)


def test_ppng2_matches_oracle():
    enc = PPNG2Encoding(3, n_quants=5, n_frequencies=2, n_features=2, rank=2)
    rng = np.random.default_rng(1)
    params = rng.uniform(-0.7, 0.7, enc.n_params).astype(np.float32)
    x = rng.uniform(0, 1, (4, 3)).astype(np.float32)
    y = np.asarray(enc.apply(jnp.asarray(params), jnp.asarray(x), compute_dtype=F32))
    tbl = params.reshape(2, 2, 3, 2, 5, 5, 2)
    for b in range(4):
        exp = _oracle_ppng2(tbl, x[b], 5, 0, 6)
        np.testing.assert_allclose(y[b], exp, rtol=1e-4, atol=1e-5)


def test_ppng3_matches_oracle():
    enc = PPNG3Encoding(3, n_quants=4, n_frequencies=2, n_features=2)
    rng = np.random.default_rng(2)
    params = rng.uniform(-1.0, 1.0, enc.n_params).astype(np.float32)
    x = rng.uniform(0, 1, (4, 3)).astype(np.float32)
    y = np.asarray(enc.apply(jnp.asarray(params), jnp.asarray(x), compute_dtype=F32))
    flat = params.reshape(2, 2, -1)
    for b in range(4):
        exp = _oracle_ppng3(flat, x[b], 4, 0, 6, 2)
        np.testing.assert_allclose(y[b], exp, rtol=1e-4, atol=1e-5)


def test_param_counts_and_output_width():
    # ppng_1.h:235, ppng_2.h:362, ppng_3.h:492, ppng.h:41
    e1 = PPNG1Encoding(3, n_quants=64, n_frequencies=6, n_features=4, rank=4)
    assert e1.n_params == 6 * 2 * 3 * 4 * 64 * 4
    assert e1.n_output_dims == 6 * 2 * 4
    e2 = PPNG2Encoding(3, n_quants=16, n_frequencies=6, n_features=4, rank=4)
    assert e2.n_params == 6 * 2 * 3 * 4 * 16 * 16 * 4
    e3 = PPNG3Encoding(3, n_quants=8, n_frequencies=6, n_features=4)
    assert e3.n_params == 6 * 2 * 8**3 * 4
    assert e3.n_output_dims == 6 * 2 * 4


def test_init_ranges():
    # PPNG1/2: U(+-0.7) (ppng_1.h:326); PPNG3: U(+-1e-4) (ppng.h:68)
    k = jax.random.PRNGKey(0)
    p1 = PPNG1Encoding(3, n_quants=8, n_frequencies=2).init_params(k)
    assert np.abs(p1).max() <= 0.7 and np.abs(p1).max() > 0.1
    p3 = PPNG3Encoding(3, n_quants=4, n_frequencies=2).init_params(k)
    assert np.abs(p3).max() <= 1e-4


def test_param_gradients_finite_diff():
    enc = PPNG1Encoding(3, n_quants=5, n_frequencies=2, n_features=2, rank=2)
    rng = np.random.default_rng(3)
    params = jnp.asarray(rng.uniform(-0.5, 0.5, enc.n_params), F32)
    x = jnp.asarray(rng.uniform(0.1, 0.9, (3, 3)), F32)

    def f(p):
        return jnp.sum(enc.apply(p, x, compute_dtype=F32) ** 2)

    g = np.asarray(jax.grad(f)(params))
    eps = 1e-3
    idxs = rng.choice(enc.n_params, 10, replace=False)
    for i in idxs:
        pp = params.at[i].add(eps)
        pm = params.at[i].add(-eps)
        fd = (float(f(pp)) - float(f(pm))) / (2 * eps)
        np.testing.assert_allclose(g[i], fd, rtol=2e-2, atol=1e-4)


def test_input_gradients_finite_diff_ppng3():
    # the reference ships analytic input grads only for PPNG3
    # (ppng_3.h:148-186); autodiff provides them here - check vs FD.
    enc = PPNG3Encoding(3, n_quants=6, n_frequencies=2, n_features=2)
    rng = np.random.default_rng(4)
    params = jnp.asarray(rng.uniform(-0.5, 0.5, enc.n_params), F32)
    x = jnp.asarray([[0.31, 0.47, 0.63]], F32)

    def f(xx):
        return jnp.sum(enc.apply(params, xx, compute_dtype=F32) ** 2)

    g = np.asarray(jax.grad(f)(x))
    eps = 1e-4
    for i in range(3):
        xp = x.at[0, i].add(eps)
        xm = x.at[0, i].add(-eps)
        fd = (float(f(xp)) - float(f(xm))) / (2 * eps)
        np.testing.assert_allclose(g[0, i], fd, rtol=5e-2, atol=1e-3)


def test_second_order_input_grads_exist():
    # grad-of-grad through PPNG3 (the reference's
    # backward_backward_input_impl, ppng_3.h:93-168)
    enc = PPNG3Encoding(3, n_quants=4, n_frequencies=2, n_features=2)
    rng = np.random.default_rng(5)
    params = jnp.asarray(rng.uniform(-0.5, 0.5, enc.n_params), F32)
    x = jnp.asarray([[0.3, 0.5, 0.7]], F32)

    def g(xx):
        def f(xi):
            return jnp.sum(enc.apply(params, xi, compute_dtype=F32) ** 2)

        return jnp.sum(jax.grad(f)(xx) ** 2)

    hg = np.asarray(jax.grad(g)(x))
    assert np.all(np.isfinite(hg))
    assert np.abs(hg).max() > 0


def test_factory_dispatch_and_validation():
    cfg = {"otype": "PPNG1", "n_quants": 8, "n_frequencies": 2}
    enc = create_encoding(3, cfg)
    assert isinstance(enc, PPNG1Encoding)
    assert enc.n_quants == 8 and enc.rank == 4 and enc.n_features == 4

    with pytest.raises(ValueError):
        create_encoding(2, cfg)  # D must be 3 (ppng_1.h:372-377)
    with pytest.raises(ValueError):
        PPNG1Encoding(3, rank=3)
    with pytest.raises(ValueError):
        PPNG1Encoding(3, n_features=3)
    for otype, cls in (("PPNG2", PPNG2Encoding), ("PPNG3", PPNG3Encoding)):
        enc = create_encoding(3, {"otype": otype, "n_quants": 4, "n_frequencies": 2})
        assert isinstance(enc, cls)


def test_hyperparams_echo():
    enc = PPNG2Encoding(3, n_quants=8, n_frequencies=3, n_features=2, rank=2)
    hp = enc.hyperparams()
    assert hp["otype"] == "PPNG2"
    assert hp["n_quants"] == 8
    assert hp["rank"] == 2


def test_padding():
    enc = PPNG1Encoding(3, n_quants=4, n_frequencies=2, n_features=2, rank=2)
    enc.set_alignment(16)
    y = enc.apply(
        jnp.zeros(enc.n_params, F32), jnp.full((2, 3), 0.5), compute_dtype=F32
    )
    assert y.shape == (2, 16)
    np.testing.assert_allclose(np.asarray(y[:, 8:]), 0.0)


def test_ppng2_big_batch_remat():
    """b > _CHUNK runs the rematerialized chunked einsum path (without
    remat, lax.map stacks every chunk's einsum residuals) and matches the
    single-chunk math, gradients included."""
    enc = PPNG2Encoding(3, n_quants=8, n_frequencies=1, n_features=2,
                        rank=2)
    old = PPNG2Encoding._CHUNK
    try:
        PPNG2Encoding._CHUNK = 64
        rng = np.random.default_rng(1)
        p = jnp.asarray(rng.normal(size=(enc.n_params,)), jnp.float32)
        x = jnp.asarray(rng.uniform(0.02, 0.98, (200, 3)), jnp.float32)

        def s(pp):
            return jnp.sum(
                enc.apply_unpadded(pp, x, compute_dtype=jnp.float32)
            )

        chunked, gchunked = jax.value_and_grad(s)(p)
    finally:
        PPNG2Encoding._CHUNK = old
    whole, gwhole = jax.value_and_grad(s)(p)
    np.testing.assert_allclose(float(chunked), float(whole), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(gchunked), np.asarray(gwhole),
                               rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("n_features", [2, 4])
@pytest.mark.parametrize("variant", ["PPNG1", "PPNG2", "PPNG3"])
def test_xla_path_matches_oracle_and_finite_difference(variant, n_features):
    """Each variant's XLA path: forward against the scalar oracle, and the
    table gradient of a random projection against central differences."""
    cls = {"PPNG1": PPNG1Encoding, "PPNG2": PPNG2Encoding,
           "PPNG3": PPNG3Encoding}[variant]
    kw = {} if variant == "PPNG3" else {"rank": 2}
    enc = cls(3, n_quants=5, n_frequencies=2, n_features=n_features, **kw)
    rng = np.random.default_rng(n_features)
    params = rng.uniform(-0.7, 0.7, enc.n_params).astype(np.float32)
    x = rng.uniform(0, 1, (3, 3)).astype(np.float32)
    y = np.asarray(enc.apply(jnp.asarray(params), jnp.asarray(x),
                             compute_dtype=F32))
    C, R = n_features, 2
    for b in range(3):
        if variant == "PPNG1":
            exp = _oracle_ppng1(params.reshape(2, 2, 3, C, 5, R), x[b], 5, 0, 6)
        elif variant == "PPNG2":
            exp = _oracle_ppng2(params.reshape(2, 2, 3, C, 5, 5, R), x[b], 5,
                                0, 6)
        else:
            exp = _oracle_ppng3(params.reshape(2, 2, -1), x[b], 5, 0, 6, C)
        np.testing.assert_allclose(y[b], exp, rtol=1e-4, atol=1e-5)

    proj = jnp.asarray(rng.normal(size=y.shape), F32)

    def f(p):
        return jnp.sum(
            enc.apply(p, jnp.asarray(x), compute_dtype=F32) * proj
        )

    g = np.asarray(jax.grad(f)(jnp.asarray(params)))
    eps = 1e-2
    for i in rng.choice(enc.n_params, 8, replace=False):
        e = np.zeros(enc.n_params, np.float32)
        e[i] = eps
        fd = (float(f(jnp.asarray(params + e)))
              - float(f(jnp.asarray(params - e)))) / (2 * eps)
        np.testing.assert_allclose(g[i], fd, rtol=2e-2, atol=2e-3)
