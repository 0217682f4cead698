"""Multiresolution (hash/tiled/dense) grid encoding - Instant-NGP.

Re-design of the reference's GridEncodingTemplated
(/root/reference/include/tiny-cuda-nn/encodings/grid.h:652-1210 and the device
helpers in common_device.h:631-718). The semantics follow the reference
exactly - including uint32 wraparound in the dense-index stride loop, the
+0.5 level staggering offset, 8-aligned per-level table sizes, and the
hash-only-when-level-overflows rule - but the implementation is a batched jnp
program instead of a per-thread CUDA kernel:

  - forward: vectorized 2^D-corner gather + N-linear/smoothstep interpolation
    over all levels at once.
  - backward (table gradients): jax.grad of the gather is an XLA
    scatter-add, the analog of the reference's atomicAdd (grid.h:214-320,
    vec.h:300-347). On a GPU XLA lowers it to atomics too, so the order of
    the sum - and the last bits of the gradient - can vary from run to run.
  - input gradients and the double-backward trio
    (grid.h:351-650, backward_backward_input_impl grid.h:902-1026) are
    subsumed by jax.grad-of-grad through the same forward program: the
    interpolation weights are polynomials of the input, so arbitrary-order
    autodiff reproduces the hand-derived Jacobian/Hessian products. Unlike
    the reference, *all* second-order blocks are supported (the reference
    documents d(dL_dgrid)/dx as unimplemented; here it falls out for free).

Stochastic interpolation (grid.h:284-299) scatters each sample's gradient to
a single randomly-chosen corner; implemented via a custom_vjp that overrides
only the table-gradient branch.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np

from ...common import (
    COMPUTE_DTYPE,
    GridType,
    HashType,
    InterpolationType,
    MAX_N_LEVELS,
    next_multiple,
    smoothstep,
)
from .base import Encoding

# Hash factors (common_device.h:647-661). Index 0 differs per hash type:
# Prime uses 1958374283, CoherentPrime uses 1 (so dim 0 stays coherent),
# ReversedPrime is Prime's list reversed.
_PRIMES = (1958374283, 2654435761, 805459861, 3674653429, 2097192037, 1434869437, 2165219737)


def _hash_factors(hash_type: HashType, n_dims: int):
    if hash_type == HashType.Prime:
        f = _PRIMES
    elif hash_type == HashType.CoherentPrime:
        f = (1,) + _PRIMES[1:]
    elif hash_type == HashType.ReversedPrime:
        f = tuple(reversed(_PRIMES))
    else:
        raise ValueError("HashType.Rng has no LCG factors (uses rng_hash)")
    return np.asarray(f[:n_dims], dtype=np.uint32)


def grid_scale(level: int, log2_per_level_scale: float, base_resolution: int) -> float:
    """exp2(level*log2(s)) * base - 1 (common_device.h:709-714)."""
    return float(
        np.exp2(level * log2_per_level_scale) * base_resolution - 1.0
    )


def grid_resolution(scale: float) -> int:
    return int(np.ceil(scale)) + 1


def stochastic_uniforms(batch: int, n_levels: int):
    """The per-(sample, level) uniform draws used by stochastic
    interpolation to choose the scatter corner (grid.h:287:
    random_val(1337, i + level * B) - fixed per sample index and level,
    shared across dims).

    Drawn over the true batch, so the chosen corners - hence gradients -
    do not depend on how a caller pads or shards the batch beyond it.
    """
    return jax.random.uniform(jax.random.PRNGKey(1337), (batch, n_levels))


class GridEncoding(Encoding):
    """Trainable multiresolution feature grid (hash / tiled / dense)."""

    pad_value = 0.0  # grid zero-pads (grid.h:749-759)

    def __init__(
        self,
        n_dims_to_encode: int,
        n_levels: int = 16,
        n_features_per_level: int = 2,
        log2_hashmap_size: int = 19,
        base_resolution: int = 16,
        per_level_scale: float = 2.0,
        grid_type: GridType = GridType.Hash,
        hash_type: HashType = HashType.CoherentPrime,
        interpolation: InterpolationType = InterpolationType.Linear,
        stochastic_interpolation: bool = False,
        max_level: float | None = None,
        seed: int = 1337,
    ):
        if n_dims_to_encode not in (2, 3, 4):
            raise ValueError("GridEncoding supports 2, 3, or 4 input dims")
        if n_features_per_level not in (1, 2, 4, 8):
            raise ValueError("n_features_per_level must be 1, 2, 4, or 8")
        if n_levels > MAX_N_LEVELS:
            raise ValueError(f"n_levels must be <= {MAX_N_LEVELS}")
        super().__init__(n_dims_to_encode)

        self.n_levels = int(n_levels)
        self.n_features_per_level = int(n_features_per_level)
        self.log2_hashmap_size = int(log2_hashmap_size)
        self.base_resolution = int(base_resolution)
        self.per_level_scale = float(per_level_scale)
        self.grid_type = grid_type
        self.hash_type = hash_type
        self.interpolation = interpolation
        self.stochastic_interpolation = bool(stochastic_interpolation)
        #: coarse-to-fine clamp in [0, 1]; None = no clamping
        #: (grid_interface.h:101-123)
        self.max_level = max_level
        self.seed = int(seed)

        # Offset table (grid.h:685-730): per-level sizes, 8-aligned, capped by
        # grid type; all in units of feature *vectors* (not scalars).
        log2_scale = math.log2(self.per_level_scale)
        max_params = 2**31  # uint32_max / 2
        offsets = []
        sizes = []
        resolutions = []
        scales = []
        offset = 0
        d = self.n_dims_to_encode
        for lvl in range(self.n_levels):
            s = grid_scale(lvl, log2_scale, self.base_resolution)
            res = grid_resolution(s)
            dense = res**d
            params_in_level = max_params if float(res) ** d > max_params else dense
            params_in_level = next_multiple(params_in_level, 8)
            if grid_type == GridType.Dense:
                pass
            elif grid_type == GridType.Tiled:
                params_in_level = min(params_in_level, self.base_resolution**d)
            elif grid_type == GridType.Hash:
                params_in_level = min(params_in_level, 1 << self.log2_hashmap_size)
            offsets.append(offset)
            sizes.append(params_in_level)
            resolutions.append(res)
            scales.append(s)
            offset += params_in_level

        self._offsets = np.asarray(offsets, dtype=np.uint32)
        self._sizes = np.asarray(sizes, dtype=np.uint32)
        self._resolutions = np.asarray(resolutions, dtype=np.uint32)
        self._scales = np.asarray(scales, dtype=np.float32)
        self._total_table_rows = offset

    #: NetworkWithInputEncoding checks this to thread needs_input_grad
    supports_input_grad_opt = True

    # -- shape / params -----------------------------------------------------
    @property
    def n_output_dims(self) -> int:
        return self.n_levels * self.n_features_per_level

    @property
    def n_params(self) -> int:
        return self._total_table_rows * self.n_features_per_level

    def init_params(self, key) -> np.ndarray:
        # U(-1e-4, 1e-4) (grid.h:1059-1062)
        return np.asarray(
            jax.random.uniform(
                key, (self.n_params,), minval=-1e-4, maxval=1e-4, dtype=np.float32
            )
        )

    # -- indexing -----------------------------------------------------------
    def _grid_indices(self, cells_u32):
        """Per-level table row index for integer grid cells.

        cells_u32: uint32 [..., L, C, D] (C = corners). Returns uint32
        [..., L, C] row index *within* each level's table (before the level
        offset). Mirrors grid_index (common_device.h:690-707) including the
        uint32-wrapping stride loop and its early-exit semantics.
        """
        L = self.n_levels
        d = self.n_dims_to_encode
        sizes = jnp.asarray(self._sizes)  # [L] uint32
        sizes_b = sizes[:, None]  # [L, 1] broadcast over corners
        res = jnp.asarray(self._resolutions)[:, None]  # [L, 1] uint32

        index = jnp.zeros(cells_u32.shape[:-1], dtype=jnp.uint32)
        stride = jnp.ones((L, 1), dtype=jnp.uint32)
        for dim in range(d):
            alive = stride <= sizes_b  # loop-entry condition
            index = index + jnp.where(alive, cells_u32[..., dim] * stride, 0)
            stride = jnp.where(alive, stride * res, stride)  # uint32 wrap

        if self.grid_type == GridType.Hash:
            if self.hash_type == HashType.Rng:
                # PCG32-advance hash (common_device.h:663-677), bit-exact
                from ..pcg32 import rng_hash

                hashed = rng_hash(cells_u32, d)
            else:
                factors = jnp.asarray(_hash_factors(self.hash_type, d))
                hashed = jnp.zeros_like(index)
                for dim in range(d):
                    hashed = hashed ^ (cells_u32[..., dim] * factors[dim])
            use_hash = sizes_b < stride
            index = jnp.where(use_hash, hashed, index)

        return index % sizes_b

    # -- forward ------------------------------------------------------------
    def apply_unpadded(
        self,
        params,
        x,
        *,
        compute_dtype=COMPUTE_DTYPE,
        max_level=None,
        needs_input_grad=True,
    ):
        """x: [B, D] fp32 in (roughly) [0, 1]^D -> [B, L*F].

        Output dim order is level-major, feature-minor (the reference's SoA
        row order, grid.h:146-148).

        `needs_input_grad=False` is the analog of the reference's
        prepare_input_gradients=false (network_with_input_encoding.h:70-81):
        the stochastic-interpolation backward then skips dL/dx, which is
        zero on that path by contract.
        """
        if self.stochastic_interpolation:
            return self._apply_stochastic(
                params, x, compute_dtype, max_level,
                needs_input_grad=needs_input_grad,
            )
        return self._apply_xla(
            params, x, compute_dtype=compute_dtype, max_level=max_level
        )

    def _apply_xla(self, params, x, *, compute_dtype=COMPUTE_DTYPE, max_level=None):
        B = x.shape[0]
        L, F, D = self.n_levels, self.n_features_per_level, self.n_dims_to_encode
        C = 1 << D

        table = params.reshape(self._total_table_rows, F)
        scales = jnp.asarray(self._scales)  # [L]

        # pos_fract (common_device.h:826-867): +0.5 staggering offset.
        pos = x[:, None, :] * scales[None, :, None] + 0.5  # [B, L, D]
        cell_f = jnp.floor(pos)
        fract = pos - cell_f
        cells = cell_f.astype(jnp.int32).astype(jnp.uint32)  # [B, L, D]

        if self.interpolation == InterpolationType.Smoothstep:
            w = smoothstep(fract)
        else:
            w = fract

        if self.interpolation == InterpolationType.Nearest:
            corner_cells = cells[:, :, None, :]  # [B, L, 1, D]
            weights = jnp.ones((B, L, 1), dtype=pos.dtype)
        else:
            corners = np.stack(
                [[(i >> dim) & 1 for dim in range(D)] for i in range(C)]
            ).astype(np.uint32)  # [C, D]
            corner_cells = cells[:, :, None, :] + jnp.asarray(corners)[None, None]
            bits = jnp.asarray(corners, dtype=pos.dtype)  # [C, D]
            # weight = prod_d (bit ? w_d : 1-w_d)
            weights = jnp.prod(
                bits[None, None] * w[:, :, None, :]
                + (1.0 - bits[None, None]) * (1.0 - w[:, :, None, :]),
                axis=-1,
            )  # [B, L, C]

        level_index = self._grid_indices(corner_cells)  # [B, L, C] uint32
        rows = jnp.asarray(self._offsets)[None, :, None] + level_index
        feats = table[rows]  # [B, L, C, F] fp32 gather

        out = jnp.sum(weights[..., None] * feats, axis=2)  # [B, L, F]

        ml = max_level if max_level is not None else self.max_level
        if ml is not None:
            # level zeroed when level >= max_level * n_levels + 1e-3
            # (grid.h:69-92; max_level normalized by num_grid_features/F = L)
            ml = jnp.asarray(ml, dtype=jnp.float32)
            lvl_ids = jnp.arange(L, dtype=jnp.float32)
            keep = lvl_ids[None, :] < (ml * L + 1e-3).reshape(-1, 1)
            out = jnp.where(keep[..., None], out, 0.0)

        return out.reshape(B, L * F).astype(compute_dtype)

    def apply(self, params, x, *, compute_dtype=COMPUTE_DTYPE, **kwargs):
        y = self.apply_unpadded(params, x, compute_dtype=compute_dtype, **kwargs)
        if self.n_to_pad:
            y = jnp.pad(y, ((0, 0), (0, self.n_to_pad)), constant_values=0.0)
        return y

    # -- stochastic interpolation (grid.h:284-299) ---------------------------
    def _stochastic_corner_rows(self, x):
        """Per (sample, level): the table row of the single randomly chosen
        corner. The reference draws random_val(1337, i + level*B) - a value
        fixed per (sample index, level), shared across dims - and picks
        corner bit d = (sample < w_d). Deterministic given the batch shape,
        like the reference."""
        B = x.shape[0]
        L, D = self.n_levels, self.n_dims_to_encode
        scales = jnp.asarray(self._scales)
        pos = x[:, None, :] * scales[None, :, None] + 0.5
        cell_f = jnp.floor(pos)
        fract = pos - cell_f
        cells = cell_f.astype(jnp.int32).astype(jnp.uint32)
        w = (
            smoothstep(fract)
            if self.interpolation == InterpolationType.Smoothstep
            else fract
        )
        u = stochastic_uniforms(B, L)[:, :, None]
        corner_bits = (u < w).astype(jnp.uint32)  # [B, L, D]
        chosen = cells + corner_bits
        level_index = self._grid_indices(chosen[:, :, None, :])[..., 0]
        return jnp.asarray(self._offsets)[None, :] + level_index  # [B, L]

    def _apply_stochastic(
        self, params, x, compute_dtype, max_level, needs_input_grad=True
    ):
        """Forward = exact interpolation; backward scatters each level's
        full dL/dy into ONE stochastically chosen corner (weight 1)."""

        @jax.custom_vjp
        def f(params, x):
            return self._apply_xla(
                params, x, compute_dtype=compute_dtype, max_level=max_level
            )

        def f_fwd(params, x):
            return f(params, x), (params, x)

        def f_bwd(res, gy):
            params, x = res
            B = x.shape[0]
            L, F = self.n_levels, self.n_features_per_level
            rows = self._stochastic_corner_rows(x).astype(jnp.int32)  # [B, L]
            g = gy.astype(jnp.float32).reshape(B, L, F)
            # max_level clamping: levels beyond the clamp were zeroed in the
            # forward and must receive no table gradient either (the
            # reference kernel early-returns, grid.h:236-243). The cotangent
            # gy is NOT automatically masked (the mask lives inside f's
            # forward, which this custom_vjp replaces).
            ml = max_level if max_level is not None else self.max_level
            if ml is not None:
                keep = jnp.arange(L, dtype=jnp.float32)[None, :] < (
                    jnp.asarray(ml, jnp.float32) * L + 1e-3
                ).reshape(-1, 1)
                g = g * keep[..., None]
            table_g = (
                jnp.zeros((self._total_table_rows, F), jnp.float32)
                .at[rows.reshape(-1)]
                .add(g.reshape(B * L, F))
            )
            if needs_input_grad:
                # dL/dx through the exact interpolation (the reference
                # computes input grads from dy_dx, unaffected by the
                # stochastic scatter)
                _, vjp = jax.vjp(
                    lambda xx: self._apply_xla(
                        params, xx, compute_dtype=compute_dtype,
                        max_level=max_level,
                    ),
                    x,
                )
                (gx,) = vjp(gy)
            else:
                # the composed-model path never uses dL/dx (the encoding is
                # the first layer) - skip the full re-vjp of the forward
                gx = jnp.zeros_like(x)
            return table_g.reshape(-1).astype(params.dtype), gx

        f.defvjp(f_fwd, f_bwd)
        return f(params, x)

    # -- config echo ----------------------------------------------------------
    def hyperparams(self):
        return {
            "otype": "Grid",
            "type": self.grid_type.value,
            "n_levels": self.n_levels,
            "n_features_per_level": self.n_features_per_level,
            "log2_hashmap_size": self.log2_hashmap_size,
            "base_resolution": self.base_resolution,
            "per_level_scale": self.per_level_scale,
            "interpolation": self.interpolation.value,
            "hash": self.hash_type.value,
            "stochastic_interpolation": self.stochastic_interpolation,
        }

    def update_hyperparams(self, params: dict) -> None:
        if "max_level" in params:
            self.max_level = params["max_level"]
