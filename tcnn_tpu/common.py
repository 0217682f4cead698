"""Core definitions shared across the framework.

Re-design of the reference's ``common.h`` / ``common_host.h``
(see /root/reference/include/tiny-cuda-nn/common.h:126-173 for the enums and
:229-235 for loss-scale / batch-granularity policy). The CUDA memory/stream
machinery of the reference (GPUMemoryArena, SyncedMultiStream, CudaGraph) is
absorbed by XLA: a ``jax.jit``-compiled step function plays the role of a
captured CUDA graph, and XLA's buffer assignment replaces the memory arena.

What survives here is the *semantic* policy:
  - enums (Activation, GridType, HashType, InterpolationType, ReductionType)
  - the mixed-precision policy: fp32 "master" params + low-precision compute
    (bf16 instead of fp16; same fp32-master design as trainer.h:75)
  - loss scaling (common.h:229-233) - kept as a knob; bf16 shares fp32's
    exponent range so the default scale matters less than on fp16 hardware,
    but we keep 128.0 for behavioral parity (it divides out exactly).
  - batch-size granularity: the reference requires multiples of 256
    (common.h:235); we adopt 128, the fused MLP kernels' row tile, and
    auto-pad in the user-facing API.
"""

from __future__ import annotations

import enum
import math

import jax.numpy as jnp
import numpy as np

# ---------------------------------------------------------------------------
# Constants
# ---------------------------------------------------------------------------

#: Batch sizes fed to jitted step functions are padded to a multiple of this.
#: (analog of BATCH_SIZE_GRANULARITY=256, common.h:235 - 128 is the row
#: tile of the fused MLP kernels.)
BATCH_SIZE_GRANULARITY = 128

#: Default loss scale (common.h:229-233 uses 128 for fp16, 1 for fp32; bf16
#: does not strictly need scaling but the knob is kept for parity).
DEFAULT_LOSS_SCALE_HALF = 128.0
DEFAULT_LOSS_SCALE_FLOAT = 1.0

#: "Zoom" factor of Squareplus/Softplus activations (K_ACT, common_device.h:100).
K_ACT = 10.0

#: The width every network output is padded to a multiple of (the reference's
#: tensor-core fragment width; object.h / fully_fused_mlp.cu:656).
OUTPUT_WIDTH_ALIGNMENT = 16

#: Maximum number of grid levels (grid_interface.h:84-88).
MAX_N_LEVELS = 128

PI = math.pi
SQRT2 = math.sqrt(2.0)

# ---------------------------------------------------------------------------
# Enums (mirroring common.h:126-173)
# ---------------------------------------------------------------------------


class Activation(enum.Enum):
    ReLU = "ReLU"
    LeakyReLU = "LeakyReLU"
    Exponential = "Exponential"
    Sine = "Sine"
    Sigmoid = "Sigmoid"
    Squareplus = "Squareplus"
    Softplus = "Softplus"
    Tanh = "Tanh"
    NONE = "None"


class GridType(enum.Enum):
    Hash = "Hash"
    Dense = "Dense"
    Tiled = "Tiled"


class HashType(enum.Enum):
    Prime = "Prime"
    CoherentPrime = "CoherentPrime"
    ReversedPrime = "ReversedPrime"
    Rng = "Rng"


class InterpolationType(enum.Enum):
    Nearest = "Nearest"
    Linear = "Linear"
    Smoothstep = "Smoothstep"


class ReductionType(enum.Enum):
    Concatenation = "Concatenation"
    Sum = "Sum"
    Product = "Product"


class GradientMode(enum.Enum):
    """How `backward` treats parameter gradients (object.h:115-119)."""

    Ignore = "Ignore"
    Overwrite = "Overwrite"
    Accumulate = "Accumulate"


def _parse_enum(enum_cls, value, what):
    if isinstance(value, enum_cls):
        return value
    if isinstance(value, str):
        for member in enum_cls:
            if member.value.lower() == value.lower():
                return member
    raise ValueError(f"Invalid {what}: {value!r}")


def parse_activation(value) -> Activation:
    return _parse_enum(Activation, value, "activation")


def parse_grid_type(value) -> GridType:
    return _parse_enum(GridType, value, "grid type")


def parse_hash_type(value) -> HashType:
    return _parse_enum(HashType, value, "hash type")


def parse_interpolation_type(value) -> InterpolationType:
    return _parse_enum(InterpolationType, value, "interpolation type")


def parse_reduction_type(value) -> ReductionType:
    return _parse_enum(ReductionType, value, "reduction type")


# ---------------------------------------------------------------------------
# Precision policy
# ---------------------------------------------------------------------------

#: Network compute precision (the analog of ``network_precision_t``,
#: common.h:114-124). bf16 operands with fp32 accumulation; masters stay
#: fp32.
COMPUTE_DTYPE = jnp.bfloat16
PARAM_DTYPE = jnp.float32


def default_loss_scale(compute_dtype=COMPUTE_DTYPE) -> float:
    if compute_dtype in (jnp.float16, jnp.bfloat16):
        return DEFAULT_LOSS_SCALE_HALF
    return DEFAULT_LOSS_SCALE_FLOAT


# ---------------------------------------------------------------------------
# Small integer helpers (common.h / common_host.h int math)
# ---------------------------------------------------------------------------


def div_round_up(a: int, b: int) -> int:
    return -(-a // b)


def next_multiple(a: int, b: int) -> int:
    return div_round_up(a, b) * b


def powi(base: int, exp: int) -> int:
    return int(base) ** int(exp)


def pad_batch(x, granularity: int = BATCH_SIZE_GRANULARITY, value: float = 1.0):
    """Pad the batch (leading) dim up to a multiple of `granularity`.

    The reference torch binding pads with ones (modules.py:181-185 uses
    F.pad default 0 - actually zeros). We pad with `value` (default 1.0 to
    keep e.g. CrossEntropy's log() finite on the pad; results for the pad
    rows are sliced away so the value is semantically irrelevant).
    """
    b = x.shape[0]
    padded = next_multiple(max(b, 1), granularity)
    if padded == b:
        return x, b
    pad_width = [(0, padded - b)] + [(0, 0)] * (x.ndim - 1)
    return jnp.pad(x, pad_width, constant_values=value), b


# ---------------------------------------------------------------------------
# Scalar math used by several components
# ---------------------------------------------------------------------------


def smoothstep(v):
    """val^2 (3 - 2 val) - common_device.h:802-804."""
    return v * v * (3.0 - 2.0 * v)


def smoothstep_derivative(v):
    return 6.0 * v * (1.0 - v)


def smoothstep_2nd_derivative(v):
    return 6.0 - 12.0 * v


def quartic_cdf(x, inv_radius):
    """CDF of the quartic kernel (common_device.h:911-917)."""
    u = x * inv_radius
    u2 = u * u
    u4 = u2 * u2
    return jnp.clip(
        (15.0 / 16.0) * u * (1.0 - (2.0 / 3.0) * u2 + (1.0 / 5.0) * u4) + 0.5,
        0.0,
        1.0,
    )


def quartic_cdf_deriv(x, inv_radius):
    u = x * inv_radius
    tmp = jnp.maximum(1.0 - u * u, 0.0)
    return (15.0 / 16.0) * tmp * tmp * inv_radius


def mse2psnr(mse):
    return -10.0 * np.log10(max(float(mse), 1e-20))
