"""Fixed-function (parameter-free) encodings.

JAX implementations of the reference's cheap encodings. These are pure
jnp - XLA fuses them into neighbouring ops (the CUDA reference needs one
hand-written kernel each). All are differentiable to
arbitrary order by JAX, subsuming the reference's hand-written backward
kernels.

Reference parity notes (file:line refer to /root/reference/include/tiny-cuda-nn):
  - Identity: encodings/identity.h:46-88 (scale/offset, pad value 1)
  - Empty: encodings/empty.h (zero-width output, zero input grads)
  - Frequency: encodings/frequency.h:46-103; output order is input-dim-major,
    frequency next, then (sin, cos) innermost: sin(2^k pi x), cos(2^k pi x).
  - TriangleWave: encodings/triangle_wave.h:46-109; x' = 2^(k-1) x,
    val = x' + 0.25 k; out = |val - floor(val) - 0.5| * 4 - 1.
  - OneBlob: encodings/oneblob.h:46-127; quartic-kernel CDF differences with
    wraparound (the +/-1 shifted kernel evaluations).
  - SphericalHarmonics: common_device.h:339-629 via a generic associated-
    Legendre recurrence that reproduces the hard-coded polynomials exactly
    (real SH with Condon-Shortley phase). NOTE the reference pads this
    encoding at the FRONT (spherical_harmonics.h:57-63), unlike every other
    encoding - replicated here.
"""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np

from ...common import COMPUTE_DTYPE, PI, quartic_cdf
from .base import Encoding


class IdentityEncoding(Encoding):
    pad_value = 1.0

    def __init__(self, n_dims_to_encode: int, scale: float = 1.0, offset: float = 0.0):
        super().__init__(n_dims_to_encode)
        self.scale = float(scale)
        self.offset = float(offset)

    @property
    def n_output_dims(self) -> int:
        return self.n_dims_to_encode

    def apply_unpadded(self, params, x, *, compute_dtype=COMPUTE_DTYPE):
        return (x * self.scale + self.offset).astype(compute_dtype)

    def hyperparams(self):
        return {"otype": "Identity", "scale": self.scale, "offset": self.offset}


class EmptyEncoding(Encoding):
    """Zero-width output; placeholder for unused input dims (empty.h:62)."""

    pad_value = 1.0

    @property
    def n_output_dims(self) -> int:
        return 0

    def apply_unpadded(self, params, x, *, compute_dtype=COMPUTE_DTYPE):
        return jnp.zeros((x.shape[0], 0), dtype=compute_dtype)

    def hyperparams(self):
        return {"otype": "Empty"}


class FrequencyEncoding(Encoding):
    pad_value = 1.0

    def __init__(self, n_dims_to_encode: int, n_frequencies: int):
        super().__init__(n_dims_to_encode)
        self.n_frequencies = int(n_frequencies)

    @property
    def n_output_dims(self) -> int:
        return self.n_dims_to_encode * self.n_frequencies * 2

    def apply_unpadded(self, params, x, *, compute_dtype=COMPUTE_DTYPE):
        # frequency.h:66-75: x_scaled = 2^k * x; out = sin(pi*x_scaled + phase)
        # with phase 0 (sin) / pi/2 (cos), interleaved per frequency.
        b = x.shape[0]
        freqs = jnp.asarray(2.0 ** np.arange(self.n_frequencies), x.dtype)
        arg = x[:, :, None] * freqs[None, None, :] * PI  # [B, D, F]
        out = jnp.stack([jnp.sin(arg), jnp.cos(arg)], axis=-1)  # [B, D, F, 2]
        return out.reshape(b, self.n_output_dims).astype(compute_dtype)

    def hyperparams(self):
        return {"otype": "Frequency", "n_frequencies": self.n_frequencies}


class TriangleWaveEncoding(Encoding):
    pad_value = 1.0

    def __init__(self, n_dims_to_encode: int, n_frequencies: int):
        super().__init__(n_dims_to_encode)
        self.n_frequencies = int(n_frequencies)

    @property
    def n_output_dims(self) -> int:
        return self.n_dims_to_encode * self.n_frequencies

    def apply_unpadded(self, params, x, *, compute_dtype=COMPUTE_DTYPE):
        # triangle_wave.h:69-76
        b = x.shape[0]
        k = np.arange(self.n_frequencies)
        scale = jnp.asarray(2.0 ** (k - 1), x.dtype)
        phase = jnp.asarray(0.25 * k, x.dtype)
        val = x[:, :, None] * scale[None, None, :] + phase[None, None, :]
        out = jnp.abs(val - jnp.floor(val) - 0.5) * 4.0 - 1.0
        return out.reshape(b, self.n_output_dims).astype(compute_dtype)

    def hyperparams(self):
        return {"otype": "TriangleWave", "n_frequencies": self.n_frequencies}


class OneBlobEncoding(Encoding):
    pad_value = 1.0

    def __init__(self, n_dims_to_encode: int, n_bins: int):
        super().__init__(n_dims_to_encode)
        self.n_bins = int(n_bins)

    @property
    def n_output_dims(self) -> int:
        return self.n_dims_to_encode * self.n_bins

    def apply_unpadded(self, params, x, *, compute_dtype=COMPUTE_DTYPE):
        # oneblob.h:70-96 (SoA kernel): per bin k, output =
        #   wrapped_cdf((k+1)/n - x) - wrapped_cdf(k/n - x)
        # where wrapped_cdf(t) = cdf(t) + cdf(t-1) + cdf(t+1) and cdf is the
        # quartic-kernel CDF with inv_radius = n_bins.
        n = self.n_bins
        b = x.shape[0]
        boundaries = jnp.asarray(np.arange(n + 1) / n, x.dtype)  # [n+1]
        t = boundaries[None, None, :] - x[:, :, None]  # [B, D, n+1]

        def wrapped_cdf(t):
            return (
                quartic_cdf(t, n)
                + quartic_cdf(t - 1.0, n)
                + quartic_cdf(t + 1.0, n)
            )

        cdf = wrapped_cdf(t)
        out = cdf[:, :, 1:] - cdf[:, :, :-1]  # [B, D, n]
        return out.reshape(b, self.n_output_dims).astype(compute_dtype)

    def hyperparams(self):
        return {"otype": "OneBlob", "n_bins": self.n_bins}


# ---------------------------------------------------------------------------
# Spherical harmonics
# ---------------------------------------------------------------------------


def _sh_norm(l: int, m: int) -> float:
    """K_{l,m} = sqrt((2l+1)/(4 pi) * (l-|m|)!/(l+|m|)!)."""
    m = abs(m)
    return math.sqrt(
        (2 * l + 1) / (4.0 * PI) * math.factorial(l - m) / math.factorial(l + m)
    )


def sh_encode(xyz, degree: int):
    """Real spherical harmonics Y_l^m (Condon-Shortley phase) up to `degree`.

    `xyz` is [B, 3] in [-1, 1] (the caller maps from the unit cube). Output
    order is (l, m) row-major: l in [0, degree), m in [-l, l] - matching the
    hard-coded polynomial table of sh_enc (common_device.h:339-629), which was
    generated from the same recurrences (StupidSH appendix A1).

    Implemented as pure polynomials in (x, y, z):
      A_m + i B_m = (x + i y)^m   (chebyshev-style recurrence)
      p_l^m(z): associated-Legendre "z-part" with sin^m(theta) factored out
                into A_m/B_m, Condon-Shortley (-1)^m included in p_m^m.
    """
    x, y, z = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    out = []

    # A_m, B_m recurrences: A_0 = 1, B_0 = 0
    a = jnp.ones_like(x)
    b = jnp.zeros_like(x)
    ab = [(a, b)]
    for _ in range(1, degree):
        a, b = x * ab[-1][0] - y * ab[-1][1], x * ab[-1][1] + y * ab[-1][0]
        ab.append((a, b))

    # p_l^m(z) via upward recurrence in l for each m.
    # p[m][l] as python dict of jnp arrays (cheap; degree <= 8).
    one = jnp.ones_like(z)
    p = {}
    for m in range(degree):
        # p_m^m = (-1)^m (2m-1)!!
        dfact = 1.0
        for i in range(1, 2 * m, 2):
            dfact *= i
        p_mm = ((-1.0) ** m) * dfact * one
        p[(m, m)] = p_mm
        if m + 1 < degree:
            p[(m + 1, m)] = z * (2 * m + 1) * p_mm
        for l in range(m + 2, degree):
            p[(l, m)] = (
                z * (2 * l - 1) * p[(l - 1, m)] - (l + m - 1) * p[(l - 2, m)]
            ) / (l - m)

    sqrt2 = math.sqrt(2.0)
    for l in range(degree):
        for m in range(-l, l + 1):
            am = abs(m)
            k = _sh_norm(l, m)
            if m < 0:
                out.append(sqrt2 * k * ab[am][1] * p[(l, am)])
            elif m == 0:
                out.append(k * p[(l, 0)])
            else:
                out.append(sqrt2 * k * ab[am][0] * p[(l, am)])

    return jnp.stack(out, axis=-1)


class SphericalHarmonicsEncoding(Encoding):
    """Degree <= 8 real SH of a direction stored in the unit cube.

    Expects 3D inputs representing normalized vectors v mapped as (v+1)/2
    (spherical_harmonics.h:103; DOCUMENTATION.md). Pads at the FRONT with 1s
    (spherical_harmonics.h:57-63) - a reference quirk we reproduce.
    """

    pad_value = 1.0

    def __init__(self, n_dims_to_encode: int, degree: int):
        if n_dims_to_encode != 3:
            raise ValueError("SphericalHarmonics requires 3 input dims")
        if not (1 <= degree <= 8):
            raise ValueError("SphericalHarmonics degree must be in [1, 8]")
        super().__init__(n_dims_to_encode)
        self.degree = int(degree)

    @property
    def n_output_dims(self) -> int:
        return self.degree * self.degree

    def apply_unpadded(self, params, x, *, compute_dtype=COMPUTE_DTYPE):
        return sh_encode(x * 2.0 - 1.0, self.degree).astype(compute_dtype)

    def apply(self, params, x, *, compute_dtype=COMPUTE_DTYPE):
        y = self.apply_unpadded(params, x, compute_dtype=compute_dtype)
        if self.n_to_pad:
            # Reference pads SH at the front (spherical_harmonics.h:57-63).
            y = jnp.pad(y, ((0, 0), (self.n_to_pad, 0)), constant_values=1.0)
        return y

    def hyperparams(self):
        return {"otype": "SphericalHarmonics", "degree": self.degree}
