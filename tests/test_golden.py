"""Golden-vector parity vs the REFERENCE implementation's own math.

tests/golden/golden.npz is generated by scripts/golden/gen_golden.py, which
compiles the reference's host-compilable device headers (hashes, grid_index,
pos_fract, SH, quartic CDF, all 9 loss kernels, adam_step, nlinear_interp)
on the CPU and runs them over deterministic inputs. These tests assert the
JAX implementation agrees - EXACTLY for integer/hash math, fp32-tight for
real-valued math. This converts "re-derived, believed exact" into
"verified exact" (BASELINE.md 'matching CUDA semantics').
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

GOLDEN_PATH = pathlib.Path(__file__).parent / "golden" / "golden.npz"
G = np.load(GOLDEN_PATH)


# ---------------------------------------------------------------------------
# Hashes (common_device.h:631-677)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d", [2, 3, 4])
def test_prime_family_hashes(d):
    from tcnn_tpu.common import HashType
    from tcnn_tpu.ops.encodings.grid import _hash_factors

    cells = G[f"hash_cells_d{d}"].astype(np.uint32)  # [64, d]
    for name, ht in [
        ("prime", HashType.Prime),
        ("coherent", HashType.CoherentPrime),
        ("reversed", HashType.ReversedPrime),
    ]:
        factors = _hash_factors(ht, d)  # uint32 [d]
        got = np.zeros(64, np.uint32)
        for dim in range(d):
            got ^= cells[:, dim] * factors[dim]
        np.testing.assert_array_equal(got, G[f"hash_{name}_d{d}"][:, 0])


@pytest.mark.parametrize("d", [2, 3, 4])
def test_rng_hash(d):
    from tcnn_tpu.ops.pcg32 import rng_hash

    cells = jnp.asarray(G[f"hash_cells_d{d}"].astype(np.uint32))
    got = np.asarray(rng_hash(cells, d))
    np.testing.assert_array_equal(got, G[f"hash_rng_d{d}"][:, 0])


# ---------------------------------------------------------------------------
# grid_index incl. uint32 stride wraparound (common_device.h:690-707),
# through the REAL GridEncoding._grid_indices dispatch path
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d", [2, 3, 4])
def test_grid_index(d):
    from tcnn_tpu.common import GridType, HashType
    from tcnn_tpu.ops.encodings.grid import GridEncoding

    sizes = G["gi_sizes"][:, 0]
    ress = G["gi_ress"][:, 0]
    types = G["gi_types"][:, 0]  # 1 = Dense else Hash
    for cfg in range(len(sizes)):
        enc = GridEncoding(
            d,
            n_levels=2,
            grid_type=GridType.Dense if types[cfg] else GridType.Hash,
            hash_type=HashType.CoherentPrime,
            log2_hashmap_size=19,
        )
        # override the level tables with the golden (size, res) pair
        enc._sizes = np.asarray([sizes[cfg]] * 2, np.uint32)
        enc._resolutions = np.asarray([ress[cfg]] * 2, np.uint32)
        cells = G[f"gi_cells_c{cfg}_d{d}"].astype(np.uint32)  # [64, d]
        cells_j = jnp.asarray(cells)[:, None, None, :]  # [B, L=1.., C=1, D]
        cells_j = jnp.broadcast_to(cells_j, (64, 2, 1, d))
        got = np.asarray(enc._grid_indices(cells_j))[:, 0, 0]
        np.testing.assert_array_equal(
            got, G[f"gi_out_c{cfg}_d{d}"][:, 0],
            err_msg=f"cfg={cfg} size={sizes[cfg]} res={ress[cfg]}",
        )


# ---------------------------------------------------------------------------
# pos_fract (common_device.h:826-867) + smoothstep
# ---------------------------------------------------------------------------


def test_pos_fract():
    from tcnn_tpu.common import smoothstep

    x = G["pf_x"][:, 0]
    scale = G["pf_scale"][:, 0]
    pos = x * scale + 0.5
    cell = np.floor(pos)
    fract = (pos - cell).astype(np.float32)
    grid = cell.astype(np.int32).astype(np.uint32)
    np.testing.assert_array_equal(grid, G["pf_grid_identity"][:, 0])
    np.testing.assert_allclose(fract, G["pf_pos_identity"][:, 0], atol=1e-6)
    np.testing.assert_array_equal(grid, G["pf_grid_smoothstep"][:, 0])
    ss = np.asarray(smoothstep(jnp.asarray(fract)))
    np.testing.assert_allclose(ss, G["pf_pos_smoothstep"][:, 0], atol=1e-6)
    dss = 6.0 * fract * (1.0 - fract)
    np.testing.assert_allclose(dss, G["pf_dpos_smoothstep"][:, 0], atol=1e-6)


# ---------------------------------------------------------------------------
# Spherical harmonics incl. input gradients (common_device.h:339-629)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("degree", range(1, 9))
def test_spherical_harmonics(degree):
    from tcnn_tpu.ops.encodings.fixed import SphericalHarmonicsEncoding

    enc = SphericalHarmonicsEncoding(3, degree)
    dirs = jnp.asarray(G["sh_dirs"])  # [32, 3] in [0,1]
    got = np.asarray(
        enc.apply_unpadded(None, dirs, compute_dtype=jnp.float32)
    )
    np.testing.assert_allclose(got, G[f"sh_out_deg{degree}"], atol=2e-5)

    dl = jnp.asarray(G[f"sh_dl_deg{degree}"][:, 0])

    def f(xx):
        return jnp.sum(
            enc.apply_unpadded(None, xx, compute_dtype=jnp.float32) * dl[None]
        )

    ggrad = np.asarray(jax.grad(f)(dirs))
    np.testing.assert_allclose(
        ggrad, G[f"sh_grad_deg{degree}"], atol=3e-4, rtol=1e-4
    )


# ---------------------------------------------------------------------------
# OneBlob quartic kernel CDF (common_device.h:911-917)
# ---------------------------------------------------------------------------


def test_quartic_cdf():
    from tcnn_tpu.common import quartic_cdf, quartic_cdf_deriv

    x = jnp.asarray(G["qc_x"][:, 0])
    np.testing.assert_allclose(
        np.asarray(quartic_cdf(x, 0.1)), G["qc_cdf"][:, 0], atol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(quartic_cdf_deriv(x, 0.1)), G["qc_pdf"][:, 0], atol=1e-6
    )


# ---------------------------------------------------------------------------
# All 9 losses (losses/*.h kernels, loss_scale=1, stride 8 > dims 3)
# ---------------------------------------------------------------------------

_LOSS_OTYPES = {
    "l2": "L2",
    "relative_l2": "RelativeL2",
    "relative_l2_luminance": "RelativeL2Luminance",
    "l1": "L1",
    "relative_l1": "RelativeL1",
    "mape": "MAPE",
    "smape": "SMAPE",
    "cross_entropy": "CrossEntropy",
    "variance_is": "Variance",
}


@pytest.mark.parametrize("name", sorted(_LOSS_OTYPES))
@pytest.mark.parametrize("use_pdf", [0, 1])
def test_losses(name, use_pdf):
    from tcnn_tpu.registry import create_loss

    loss = create_loss({"otype": _LOSS_OTYPES[name]})
    pred = jnp.asarray(G["loss_pred"])  # [32, 8]
    tgt = jnp.asarray(G["loss_target"])  # [32, 3]
    pdf = jnp.asarray(G["loss_pdf"]) if use_pdf else jnp.ones_like(tgt)
    values, grads = loss.value_and_grad_fn(pred, tgt, pdf)
    np.testing.assert_allclose(
        np.asarray(values), G[f"loss_{name}_pdf{use_pdf}_values"],
        atol=1e-6, rtol=1e-5,
    )
    np.testing.assert_allclose(
        np.asarray(grads), G[f"loss_{name}_pdf{use_pdf}_grads"],
        atol=1e-6, rtol=1e-5,
    )


# ---------------------------------------------------------------------------
# Adam trajectory (optimizers/adam.h:47-188 kernel, 40 steps)
# ---------------------------------------------------------------------------


def test_adam_trajectory():
    from tcnn_tpu.optimizers.adam import AdamOptimizer

    n, n_steps = 160, 40
    opt = AdamOptimizer(
        learning_rate=1e-2, beta1=0.9, beta2=0.99, epsilon=1e-8,
        l2_reg=1e-5, relative_decay=0.01, absolute_decay=0.001,
        clipping_magnitude=1.5, non_matrix_learning_rate_factor=0.5,
    )
    opt.allocate(n, [(12, 8)])  # 96 matrix weights, 64 non-matrix
    assert opt.n_matrix_weights == 96
    state = opt.init_state()
    w = jnp.asarray(G["adam_w0"][:, 0])
    grads = G["adam_grads"]  # [40, 160], pre-loss-scale
    for s in range(n_steps):
        g = jnp.asarray(grads[s]) * 128.0
        state, w = opt.step(state, 128.0, w, g)
    np.testing.assert_allclose(
        np.asarray(w), G["adam_w_final"][:, 0], atol=1e-5, rtol=1e-4
    )
    np.testing.assert_allclose(
        np.asarray(state["first_moments"]), G["adam_m1_final"][:, 0],
        atol=1e-5, rtol=1e-4,
    )
    np.testing.assert_allclose(
        np.asarray(state["second_moments"]), G["adam_m2_final"][:, 0],
        atol=1e-5, rtol=1e-4,
    )


# ---------------------------------------------------------------------------
# PPNG N-linear interpolation (interp.h:25-72) through PPNG3's real path
# ---------------------------------------------------------------------------


def test_ppng_nlinear_interp():
    from tcnn_tpu.ops.encodings.ppng import PPNG3Encoding

    sc = G["ni_sc"]  # [16, 3] in [-1, 1]
    feats = G["ni_feats"]  # [512, 2] (R=8, C=2)
    enc = PPNG3Encoding(
        3, n_quants=8, n_features=2, n_frequencies=1,
        log2_min_freq=0, log2_max_freq=0, rank=1,
    )
    # params [F=1, 2 phases, Q,Q,Q, C]; fill the sin-phase block with the
    # golden features (flat offset = sum p_i * Q^i times C, i.e. axis order
    # [p2, p1, p0, c] row-major - same convention, interp.h:47)
    params = np.zeros(enc.n_params, np.float32)
    params[: feats.size] = feats.reshape(-1)
    # invert the frequency mapping: sc = sin(pi * (x - 0.5)) (phase 0;
    # _frequencies is 2^log2_min * pi)
    x = jnp.asarray(0.5 + np.arcsin(sc) / np.pi, jnp.float32)
    out = np.asarray(
        enc.apply_unpadded(jnp.asarray(params), x, compute_dtype=jnp.float32)
    )  # [16, F*2*C] -> sin-phase block = first C columns
    np.testing.assert_allclose(out[:, :2], G["ni_out"], atol=1e-5, rtol=1e-5)
