"""PPNG1/2/3 encodings (fork-only feature of leejaeyong7/tiny-cuda-nn).

"PPNG" = frequency-modulated quantized feature grids with rank
decomposition. Reference semantics (re-derived, not translated, from
/root/reference/include/tiny-cuda-nn/encodings/ppng.h:29-118, ppng_1.h,
ppng_2.h, ppng_3.h and interp.h:25-131):

For every frequency index f in [0, F) and phase s in {0, 1}:

    freq_f  = 2^(log2_min + f*(log2_max - log2_min)/(F-1)) * pi
    sc_i    = sin(freq_f * (x_i - 0.5) + s*pi/2)          (ppng_1.h:174)
    p_i     = (sc_i + 1)/2 * (Q - 1)                      (interp.h:41)
    p0_i    = clamp(floor(p_i), 0, Q-1); p1_i = clamp(ceil(p_i), 0, Q-1)
    w_i     = p_i - p0_i

and C output features per (f, s), giving output width F*2*C. The three
variants differ in how learned tables produce those features:

  PPNG1 (rank-R 1-D decomposition, ppng_1.h:13-53): per-axis 1-D tables
    [F, 2, D, C, Q, R];  out_c = sum_r prod_i lerp(tbl[i,c,p0_i,r],
    tbl[i,c,p1_i,r], w_i).  n_params = F*2*D*C*Q*R.

  PPNG2 (rank-R 2-D planes, ppng_2.h:12-76): per-axis 2-D tables
    [F, 2, 3, C, Q, Q, R]; plane 0 is indexed [z, y], plane 1 [z, x],
    plane 2 [y, x] (ppng_2.h:49-62). The output is a sum over the 8
    trilinear corners of the *product of plane corner values* - NOT the
    product of bilinearly interpolated planes:
      out_c = sum_r sum_{(a,b,c2) in {0,1}^3} W_abc2
              * fx[p_c2[2], p_b[1]] * fy[p_c2[2], p_a[0]] * fz[p_b[1], p_a[0]]
    with W_abc2 = prod over dims of (bit ? w : 1-w) (ppng_2.h:32-72).
    n_params = F*2*3*C*Q*Q*R.  D = 3 only.

  PPNG3 (dense, rank 1, ppng_3.h:476-494 + interp.h:25-72): one dense
    D-dim table [F, 2, Q^D, C] with flat index sum_i p_i * Q^i; output is
    plain N-linear interpolation. n_params = F*2*Q^D*C. The reference
    additionally ships analytic input-gradient and double-backward kernels
    for PPNG3 (ppng_3.h:14-230); here ALL variants get arbitrary-order
    input and parameter gradients from JAX autodiff through the same
    forward program (the interpolation weights are smooth functions of x
    through sin/cos, so jax.grad reproduces the hand-written dsc/ddsc
    chains, ppng_3.h:178-179,224-225 exactly).

Initialization: PPNG1/PPNG2 U(+-0.7) (ppng_1.h:324-327, ppng_2.h:451-454);
PPNG3 inherits the base U(+-1e-4) (ppng.h:66-69).

Factory defaults (ppng_1.h:340-378): log2_min_freq 0, log2_max_freq 6,
n_quants 64, n_frequencies 6, rank 4, n_features 4; input dims must be 3.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np

from ...common import COMPUTE_DTYPE
from .base import Encoding

_HALF_PI = math.pi / 2.0
# the reference's single-precision pi literal (ppng_1.h:164)
_PI_F = 3.1415926535


class PPNGBase(Encoding):
    """Shared frequency/phase/quantization machinery for PPNG1/2/3."""

    pad_value = 0.0
    rank: int = 1

    def __init__(
        self,
        n_dims_to_encode: int,
        log2_min_freq: int = 0,
        log2_max_freq: int = 6,
        n_quants: int = 64,
        n_frequencies: int = 6,
        n_features: int = 4,
        rank: int = 4,
    ):
        if n_dims_to_encode != 3:
            # ppng_1.h:372-377: only D=3 is instantiated
            raise ValueError(f"{self.otype_name}: n_dims_to_encode must be 3")
        super().__init__(n_dims_to_encode)
        self.log2_min_freq = int(log2_min_freq)
        self.log2_max_freq = int(log2_max_freq)
        self.n_quants = int(n_quants)
        self.n_frequencies = int(n_frequencies)
        self.n_features = int(n_features)
        self.rank = int(rank)
        self._validate()

    otype_name = "PPNG"

    def _validate(self):
        if self.n_features not in (2, 4, 8):
            raise ValueError(f"{self.otype_name}: n_features must be 2, 4 or 8")
        if self.rank not in (2, 4, 8, 16):
            raise ValueError(f"{self.otype_name}: rank must be 2, 4, 8 or 16")

    @property
    def n_output_dims(self) -> int:
        return self.n_frequencies * 2 * self.n_features

    def init_params(self, key) -> np.ndarray:
        # PPNG1/2 override the base grid init with U(+-0.7) (ppng_1.h:326)
        return np.asarray(
            jax.random.uniform(
                key, (self.n_params,), minval=-0.7, maxval=0.7, dtype=np.float32
            )
        )

    # -- shared math --------------------------------------------------------
    def _frequencies(self):
        f = np.arange(self.n_frequencies, dtype=np.float64)
        lo, hi = self.log2_min_freq, self.log2_max_freq
        if self.n_frequencies > 1:
            base = f * (hi - lo) / (self.n_frequencies - 1) + lo
        else:
            base = np.full_like(f, lo)
        return np.exp2(base).astype(np.float32) * _PI_F

    def _quant_coords(self, x):
        """x [B, D] -> (p0, p1 int32 [B, F, 2, D], w f32 [B, F, 2, D])."""
        q = self.n_quants
        freqs = jnp.asarray(self._frequencies())  # [F]
        phase = jnp.asarray([0.0, _HALF_PI], dtype=jnp.float32)  # [2]
        arg = (
            freqs[None, :, None, None] * (x[:, None, None, :] - 0.5)
            + phase[None, None, :, None]
        )  # [B, F, 2, D]
        sc = jnp.sin(arg)
        p = (sc + 1.0) * 0.5 * (q - 1)
        p0 = jnp.clip(jnp.floor(p), 0, q - 1)
        p1 = jnp.clip(jnp.ceil(p), 0, q - 1)
        w = p - p0
        return p0.astype(jnp.int32), p1.astype(jnp.int32), w

    # -- Encoding API ---------------------------------------------------------
    def apply_unpadded(self, params, x, *, compute_dtype=COMPUTE_DTYPE, **_):
        raise NotImplementedError

    def apply(self, params, x, *, compute_dtype=COMPUTE_DTYPE, **kwargs):
        y = self.apply_unpadded(params, x, compute_dtype=compute_dtype, **kwargs)
        if self.n_to_pad:
            y = jnp.pad(y, ((0, 0), (0, self.n_to_pad)), constant_values=0.0)
        return y

    def hyperparams(self):
        return {
            "otype": self.otype_name,
            "n_frequencies": self.n_frequencies,
            "log2_min_freq": self.log2_min_freq,
            "log2_max_freq": self.log2_max_freq,
            "n_quants": self.n_quants,
            "n_features_per_level": self.n_features,
            "rank": self.rank,
        }


class PPNG1Encoding(PPNGBase):
    """Rank-decomposed per-axis 1-D frequency-feature tables."""

    otype_name = "PPNG1"

    @property
    def n_params(self) -> int:
        # ppng_1.h:235
        return (
            self.n_frequencies
            * 2
            * self.n_dims_to_encode
            * self.n_features
            * self.n_quants
            * self.rank
        )

    def apply_unpadded(self, params, x, *, compute_dtype=COMPUTE_DTYPE, **_):
        B = x.shape[0]
        F, D, C = self.n_frequencies, self.n_dims_to_encode, self.n_features
        Q, R = self.n_quants, self.rank
        p0, p1, w = self._quant_coords(x.astype(jnp.float32))  # [B,F,2,D]

        # 1-D lerp as a 2-nonzero interpolation-weight vector over the Q
        # axis: the gather becomes a batched matmul (and its transpose the
        # table-gradient scatter under autodiff)
        K = F * 2 * D
        qi = jnp.arange(Q)[None, None]
        p0f = p0.reshape(B, K, 1)
        p1f = p1.reshape(B, K, 1)
        wf = w.reshape(B, K, 1)
        # (1-w) at p0 plus w at p1; p0 == p1 (w = 0) sums to 1 at p0: exact
        wvec = (qi == p0f) * (1.0 - wf) + (qi == p1f) * wf  # [B, K, Q]
        # params layout [F,2,D,C,Q,R] -> per-k [Q, C*R]
        tblr = params.reshape(K, C, Q, R).transpose(0, 2, 1, 3).reshape(
            K, Q, C * R
        )
        lerped = jnp.einsum(
            "bkq,kqm->bkm", wvec, tblr, preferred_element_type=jnp.float32
        ).reshape(B, F, 2, D, C, R)
        out = jnp.sum(jnp.prod(lerped, axis=3), axis=-1)  # [B,F,2,C]
        return out.reshape(B, F * 2 * C).astype(compute_dtype)


class PPNG2Encoding(PPNGBase):
    """Rank-decomposed per-axis 2-D plane tables, trilinear corner mixing."""

    otype_name = "PPNG2"

    @property
    def n_params(self) -> int:
        # ppng_2.h:362
        return (
            self.n_frequencies
            * 2
            * self.n_dims_to_encode
            * self.n_features
            * self.n_quants
            * self.n_quants
            * self.rank
        )

    #: batch chunk for the einsum intermediates ([bc,F,2,C,Q,R] per plane)
    _CHUNK = 16384

    def apply_unpadded(self, params, x, *, compute_dtype=COMPUTE_DTYPE, **_):
        """Each plane's 2x2 corner sub-block is extracted with one-hot
        einsums over the Q axes (under autodiff the transposed einsums are
        the table-gradient scatter); the 8-corner rank-coupled combine
        (ppng_2.h:32-39) then runs on the tiny [.., 2, 2] blocks."""
        B = x.shape[0]
        F, C = self.n_frequencies, self.n_features
        Q, R = self.n_quants, self.rank
        tbl = params.reshape(F, 2, 3, C, Q, Q, R)
        qi = jnp.arange(Q)

        def chunk_fn(xc):
            bc = xc.shape[0]
            p0, p1, w = self._quant_coords(xc.astype(jnp.float32))
            # bit-indexed one-hot pairs over Q: [bc,F,2,3,2,Q]
            oh = (
                jnp.stack([p0, p1], axis=-1)[..., None] == qi
            ).astype(jnp.float32)

            # plane 0 rows=dim2(z) cols=dim1(y); plane 1 (z,x); plane 2 (y,x)
            dims = [(2, 1), (2, 0), (1, 0)]
            planes = []
            for d, (rd, cd) in enumerate(dims):
                u = oh[:, :, :, rd]  # [bc,F,2,2,Q]
                v = oh[:, :, :, cd]
                t1 = jnp.einsum(
                    "bfsuq,fscqkr->bfsuckr", u, tbl[:, :, d],
                    preferred_element_type=jnp.float32,
                )  # [bc,F,2,2,C,Q,R]
                planes.append(
                    jnp.einsum(
                        "bfsvk,bfsuckr->bfsuvcr", v, t1,
                        preferred_element_type=jnp.float32,
                    )
                )  # [bc,F,2,2(row),2(col),C,R]
            P0, P1, P2 = planes

            out = jnp.zeros((bc, F, 2, C), jnp.float32)
            for corner in range(8):
                a = (corner >> 2) & 1  # x bit (w[0])
                b = (corner >> 1) & 1  # y bit (w[1])
                c2 = corner & 1  # z bit (w[2])
                wx = w[..., 0] if a else 1.0 - w[..., 0]
                wy = w[..., 1] if b else 1.0 - w[..., 1]
                wz = w[..., 2] if c2 else 1.0 - w[..., 2]
                weight = wx * wy * wz  # [bc,F,2]
                val = jnp.sum(
                    P0[:, :, :, c2, b] * P1[:, :, :, c2, a]
                    * P2[:, :, :, b, a],
                    axis=-1,
                )  # [bc,F,2,C]
                out = out + weight[..., None] * val
            return out.reshape(bc, F * 2 * C)

        if B <= self._CHUNK:
            out = chunk_fn(x)
        else:
            # bound the per-plane einsum intermediates; pad to a chunk
            # multiple and run chunks sequentially. chunk_fn is
            # REMATERIALIZED: under autodiff, lax.map otherwise stacks
            # every chunk's einsum residuals ([nb, bc, F, 2, C, R] f32).
            # Recomputing the chunk forward in the backward keeps only
            # [bc, D] inputs per chunk live.
            nb = -(-B // self._CHUNK)
            xp = jnp.pad(x, ((0, nb * self._CHUNK - B), (0, 0)))
            out = jax.lax.map(
                jax.checkpoint(chunk_fn),
                xp.reshape(nb, self._CHUNK, x.shape[1]),
            ).reshape(nb * self._CHUNK, -1)[:B]
        return out.astype(compute_dtype)


class PPNG3Encoding(PPNGBase):
    """Dense Q^D frequency-feature grid (rank 1); full input-gradient and
    double-backward support via autodiff (the reference's grad_point_helper /
    grad_grad_helper trio, ppng_3.h:14-230)."""

    otype_name = "PPNG3"

    def __init__(self, n_dims_to_encode: int, **kw):
        kw.setdefault("rank", 1)
        super().__init__(n_dims_to_encode, **kw)

    def _validate(self):
        if self.n_features not in (1, 2, 4, 8):
            raise ValueError("PPNG3: n_features must be 1, 2, 4 or 8")
        if self.rank != 1:
            raise ValueError("PPNG3: rank is fixed at 1")

    def init_params(self, key) -> np.ndarray:
        # PPNG3 keeps the base-class grid-style init (ppng.h:66-69)
        return np.asarray(
            jax.random.uniform(
                key, (self.n_params,), minval=-1e-4, maxval=1e-4, dtype=np.float32
            )
        )

    @property
    def n_params(self) -> int:
        # ppng_3.h:488-493
        return (
            self.n_frequencies
            * 2
            * self.n_quants**self.n_dims_to_encode
            * self.n_features
        )

    def apply_unpadded(self, params, x, *, compute_dtype=COMPUTE_DTYPE, **_):
        B = x.shape[0]
        F, D, C = self.n_frequencies, self.n_dims_to_encode, self.n_features
        Q = self.n_quants
        # flat index sum_i p_i * Q^i (interp.h:47) -> axes [p_{D-1} .. p_0]
        tbl = params.reshape((F, 2) + (Q,) * D + (C,))
        p0, p1, w = self._quant_coords(x.astype(jnp.float32))  # [B,F,2,D]
        p = jnp.stack([p0, p1], axis=-1)  # [B,F,2,D,2]

        fi = jnp.arange(F)[None, :, None]
        si = jnp.arange(2)[None, None, :]

        out = jnp.zeros((B, F, 2, C), jnp.float32)
        for corner in range(1 << D):
            idx = []
            weight = 1.0
            for i in reversed(range(D)):  # table axis order p_{D-1}..p_0
                bit = (corner >> i) & 1
                idx.append(p[:, :, :, i, bit])
                weight = weight * (w[..., i] if bit else 1.0 - w[..., i])
            feats = tbl[(fi, si, *idx)]  # [B,F,2,C]
            out = out + weight[..., None] * feats
        return out.reshape(B, F * 2 * C).astype(compute_dtype)
