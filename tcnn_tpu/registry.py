"""JSON "otype" registries + factories.

Mirror of src/encoding.cu:56-150, src/network.cu:70-130, src/loss.cu:54-85,
src/optimizer.cu:49-80 in the reference. The JSON schema is the public config
contract (DOCUMENTATION.md); keys are matched case-insensitively like the
reference's ci_hashmap (common_host.h:242-246).

Runtime extension points `register_encoding` / `register_loss` (and, beyond
the reference, `register_network` / `register_optimizer`) let downstream code
add otypes.
"""

from __future__ import annotations

from .common import (
    GridType,
    parse_activation,
    parse_grid_type,
    parse_hash_type,
    parse_interpolation_type,
    parse_reduction_type,
)
from .ops.encodings.base import Encoding
from .ops.encodings.composite import CompositeEncoding
from .ops.encodings.fixed import (
    EmptyEncoding,
    FrequencyEncoding,
    IdentityEncoding,
    OneBlobEncoding,
    SphericalHarmonicsEncoding,
    TriangleWaveEncoding,
)
from .ops.encodings.grid import GridEncoding
from .ops.encodings.ppng import PPNG1Encoding, PPNG2Encoding, PPNG3Encoding
from .ops import losses as _losses
from .models.mlp import CutlassMLP, FullyFusedMLP
from .optimizers.adam import AdamOptimizer
from .optimizers.composite import CompositeOptimizer
from .optimizers.novograd import NovogradOptimizer
from .optimizers.sgd import SGDOptimizer
from .optimizers.shampoo import ShampooOptimizer
from .optimizers.wrappers import (
    AverageOptimizer,
    BatchedOptimizer,
    EmaOptimizer,
    ExponentialDecayOptimizer,
    LookaheadOptimizer,
)

# ---------------------------------------------------------------------------
# Case-insensitive config access
# ---------------------------------------------------------------------------


def cfg_get(config: dict, key: str, default=None):
    """Case-insensitive config lookup (ci_hashmap, common_host.h:242-246)."""
    if key in config:
        return config[key]
    kl = key.lower()
    for k, v in config.items():
        if isinstance(k, str) and k.lower() == kl:
            return v
    return default


def cfg_has(config: dict, key: str) -> bool:
    sentinel = object()
    return cfg_get(config, key, sentinel) is not sentinel


# ---------------------------------------------------------------------------
# Encodings
# ---------------------------------------------------------------------------

_ENCODING_FACTORIES: dict = {}


def register_encoding(name: str, factory) -> None:
    """factory(n_dims_to_encode, config_dict) -> Encoding (encoding.cu:138-141)."""
    _ENCODING_FACTORIES[name.lower()] = factory


def create_encoding(
    n_dims_to_encode: int, encoding: dict, alignment: int = 1
) -> Encoding:
    """create_encoding (encoding.cu:144-160); default otype is OneBlob."""
    name = cfg_get(encoding, "otype", "OneBlob")
    factory = _ENCODING_FACTORIES.get(str(name).lower())
    if factory is None:
        raise ValueError(f"Encoding '{name}' not found")
    enc = factory(int(n_dims_to_encode), encoding)
    if alignment > 1:
        enc.set_alignment(alignment)
    return enc


def _make_grid(n_dims, cfg):
    otype = str(cfg_get(cfg, "otype", "Grid"))
    default_type = (
        "Tiled"
        if otype.lower() == "tiledgrid"
        else ("Dense" if otype.lower() == "densegrid" else "Hash")
    )  # grid.h:1147
    grid_type = parse_grid_type(cfg_get(cfg, "type", default_type))
    n_features_per_level = int(cfg_get(cfg, "n_features_per_level", 2))
    if cfg_has(cfg, "n_features") or cfg_has(cfg, "n_grid_features"):
        if cfg_has(cfg, "n_levels"):
            raise ValueError(
                "GridEncoding: may not specify n_features and n_levels simultaneously"
            )
        n_features = int(
            cfg_get(cfg, "n_features", cfg_get(cfg, "n_grid_features"))
        )
        n_levels = n_features // n_features_per_level
    else:
        n_levels = int(cfg_get(cfg, "n_levels", 16))
    base_resolution = int(cfg_get(cfg, "base_resolution", 16))
    # grid.h:1167: Dense default scale targets resolution 256 at the last level
    if grid_type == GridType.Dense:
        import math

        default_scale = (
            math.exp(math.log(256.0 / base_resolution) / max(n_levels - 1, 1))
            if n_levels > 1
            else 2.0
        )
    else:
        default_scale = 2.0
    return GridEncoding(
        n_dims,
        n_levels=n_levels,
        n_features_per_level=n_features_per_level,
        log2_hashmap_size=int(cfg_get(cfg, "log2_hashmap_size", 19)),
        base_resolution=base_resolution,
        per_level_scale=float(cfg_get(cfg, "per_level_scale", default_scale)),
        grid_type=grid_type,
        hash_type=parse_hash_type(cfg_get(cfg, "hash", "CoherentPrime")),
        interpolation=parse_interpolation_type(
            cfg_get(cfg, "interpolation", "Linear")
        ),
        stochastic_interpolation=bool(
            cfg_get(cfg, "stochastic_interpolation", False)
        ),
    )


def _make_composite(n_dims, cfg):
    nested_cfgs = cfg_get(cfg, "nested")
    if not isinstance(nested_cfgs, (list, tuple)) or not nested_cfgs:
        raise ValueError("Must provide an array of nested encodings to Composite")
    reduction = parse_reduction_type(cfg_get(cfg, "reduction", "Concatenation"))

    # composite.h:147-188: explicit dims, one inferred remainder allowed
    total_explicit = 0
    any_begin = any(cfg_has(c, "dims_to_encode_begin") for c in nested_cfgs)
    if not any_begin:
        total_explicit = sum(
            int(cfg_get(c, "n_dims_to_encode", 0)) for c in nested_cfgs
        )
        if total_explicit > n_dims:
            raise ValueError(
                f"Composite: nested encodings encode more dims ({total_explicit}) "
                f"than available ({n_dims})"
            )
    unspecified = None if any_begin else n_dims - total_explicit

    nested, begins = [], []
    offset = 0
    for c in nested_cfgs:
        if cfg_has(c, "n_dims_to_encode"):
            if cfg_has(c, "dims_to_encode_begin"):
                offset = int(cfg_get(c, "dims_to_encode_begin"))
            nd = int(cfg_get(c, "n_dims_to_encode"))
        else:
            if unspecified is None:
                raise ValueError(
                    "Composite: may only leave n_dims_to_encode unspecified "
                    "for a single nested encoding"
                )
            nd = unspecified
            unspecified = None
        if nd > 0:
            nested.append(create_encoding(nd, c, 1))
            begins.append(offset)
        offset += nd

    return CompositeEncoding(n_dims, nested, begins, reduction)


def _make_nrc(n_dims, cfg):
    # encoding.cu:96-118 - the Neural Radiance Caching preset
    return _make_composite(
        n_dims,
        {
            "otype": "Composite",
            "nested": [
                {
                    "n_dims_to_encode": 3,
                    "otype": "TriangleWave",
                    "n_frequencies": cfg_get(cfg, "n_frequencies", 12),
                },
                {
                    "n_dims_to_encode": 5,
                    "otype": "OneBlob",
                    "n_bins": cfg_get(cfg, "n_bins", 4),
                },
                {"otype": "Identity"},
            ],
        },
    )


register_encoding("Composite", _make_composite)
register_encoding("Empty", lambda n, c: EmptyEncoding(n))
register_encoding(
    "Frequency",
    lambda n, c: FrequencyEncoding(n, int(cfg_get(c, "n_frequencies", 12))),
)
register_encoding("Grid", _make_grid)
register_encoding("HashGrid", _make_grid)
register_encoding("TiledGrid", _make_grid)
register_encoding("DenseGrid", _make_grid)
register_encoding(
    "Identity",
    lambda n, c: IdentityEncoding(
        n, float(cfg_get(c, "scale", 1.0)), float(cfg_get(c, "offset", 0.0))
    ),
)
register_encoding(
    "OneBlob", lambda n, c: OneBlobEncoding(n, int(cfg_get(c, "n_bins", 16)))
)
register_encoding(
    "SphericalHarmonics",
    lambda n, c: SphericalHarmonicsEncoding(n, int(cfg_get(c, "degree", 4))),
)
register_encoding(
    "TriangleWave",
    lambda n, c: TriangleWaveEncoding(n, int(cfg_get(c, "n_frequencies", 12))),
)
register_encoding("OneBlobFrequency", _make_nrc)
register_encoding("NRC", _make_nrc)


def _make_ppng(cls):
    def make(n_dims, cfg):
        # factory defaults: ppng_1.h:340-367 (shared by all three variants)
        kw = dict(
            log2_min_freq=int(cfg_get(cfg, "log2_min_freq", 0)),
            log2_max_freq=int(cfg_get(cfg, "log2_max_freq", 6)),
            n_quants=int(cfg_get(cfg, "n_quants", 64)),
            n_frequencies=int(cfg_get(cfg, "n_frequencies", 6)),
            n_features=int(cfg_get(cfg, "n_features", 4)),
        )
        if cls is not PPNG3Encoding:
            kw["rank"] = int(cfg_get(cfg, "rank", 4))
        return cls(n_dims, **kw)

    return make


register_encoding("PPNG1", _make_ppng(PPNG1Encoding))
register_encoding("PPNG2", _make_ppng(PPNG2Encoding))
register_encoding("PPNG3", _make_ppng(PPNG3Encoding))

# ---------------------------------------------------------------------------
# Networks
# ---------------------------------------------------------------------------

_NETWORK_FACTORIES: dict = {}


def register_network(name: str, factory) -> None:
    """factory(input_width, n_output_dims, config) -> Network."""
    _NETWORK_FACTORIES[name.lower()] = factory


def _select_network(network: dict) -> str:
    """network.cu:56-74: 'MLP' resolves to CutlassMLP."""
    otype = str(cfg_get(network, "otype", "MLP"))
    if otype.lower() == "mlp":
        return "cutlassmlp"
    return otype.lower()


def minimum_alignment(network: dict) -> int:
    """network.cu:76-95 - input-width alignment the network demands (16)."""
    return 16


def create_network(input_width: int, n_output_dims: int, network: dict):
    name = _select_network(network)
    factory = _NETWORK_FACTORIES.get(name)
    if factory is None:
        raise ValueError(f"Network '{name}' not found")
    return factory(int(input_width), int(n_output_dims), network)


def _mlp_args(cfg):
    return dict(
        n_neurons=int(cfg_get(cfg, "n_neurons", 128)),
        n_hidden_layers=int(cfg_get(cfg, "n_hidden_layers", 5)),
        activation=parse_activation(cfg_get(cfg, "activation", "ReLU")),
        output_activation=parse_activation(
            cfg_get(cfg, "output_activation", "None")
        ),
    )


register_network(
    "FullyFusedMLP",
    lambda i, o, c: FullyFusedMLP(i, o, **_mlp_args(c)),
)
register_network(
    "CutlassMLP",
    lambda i, o, c: CutlassMLP(i, o, **_mlp_args(c)),
)

# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------

_LOSS_FACTORIES: dict = {}


def register_loss(name: str, factory) -> None:
    """factory(config) -> Loss (loss.cu:77-82)."""
    _LOSS_FACTORIES[name.lower()] = factory


def create_loss(loss: dict):
    """loss.cu:85 - default otype is RelativeL2."""
    name = str(cfg_get(loss, "otype", "RelativeL2"))
    factory = _LOSS_FACTORIES.get(name.lower())
    if factory is None:
        raise ValueError(f"Loss '{name}' not found")
    return factory(loss)


for _name, _cls in [
    ("L2", _losses.L2Loss),
    ("RelativeL2", _losses.RelativeL2Loss),
    ("RelativeL2Luminance", _losses.RelativeL2LuminanceLoss),
    ("L1", _losses.L1Loss),
    ("RelativeL1", _losses.RelativeL1Loss),
    ("MAPE", _losses.MapeLoss),
    ("SMAPE", _losses.SmapeLoss),
    ("CrossEntropy", _losses.CrossEntropyLoss),
    ("Variance", _losses.VarianceIsLoss),
]:
    register_loss(_name, (lambda cls: (lambda c: cls()))(_cls))

# ---------------------------------------------------------------------------
# Optimizers
# ---------------------------------------------------------------------------

_OPTIMIZER_FACTORIES: dict = {}


def register_optimizer(name: str, factory) -> None:
    """factory(config) -> Optimizer."""
    _OPTIMIZER_FACTORIES[name.lower()] = factory


def create_optimizer(optimizer: dict):
    """optimizer.cu:49-80 - default otype is Adam."""
    name = str(cfg_get(optimizer, "otype", "Adam"))
    factory = _OPTIMIZER_FACTORIES.get(name.lower())
    if factory is None:
        raise ValueError(f"Optimizer '{name}' not found")
    opt = factory(optimizer)
    if cfg_has(optimizer, "n_params_to_optimize"):
        opt.n_params_to_optimize = int(cfg_get(optimizer, "n_params_to_optimize"))
    return opt


def _nested_of(cfg):
    return create_optimizer(cfg_get(cfg, "nested", {}))


register_optimizer(
    "Adam",
    lambda c: AdamOptimizer(
        learning_rate=float(cfg_get(c, "learning_rate", 1e-3)),
        beta1=float(cfg_get(c, "beta1", 0.9)),
        beta2=float(cfg_get(c, "beta2", 0.999)),
        epsilon=float(cfg_get(c, "epsilon", 1e-8)),
        l2_reg=float(cfg_get(c, "l2_reg", 1e-8)),
        relative_decay=float(cfg_get(c, "relative_decay", 0.0)),
        absolute_decay=float(cfg_get(c, "absolute_decay", 0.0)),
        adabound=bool(cfg_get(c, "adabound", False)),
        clipping_magnitude=float(cfg_get(c, "clipping_magnitude", 0.0)),
        non_matrix_learning_rate_factor=float(
            cfg_get(c, "non_matrix_learning_rate_factor", 1.0)
        ),
        optimize_matrix_params=bool(cfg_get(c, "optimize_matrix_params", True)),
        optimize_non_matrix_params=bool(
            cfg_get(c, "optimize_non_matrix_params", True)
        ),
    ),
)
register_optimizer(
    "Shampoo",
    lambda c: ShampooOptimizer(
        learning_rate=float(cfg_get(c, "learning_rate", 1e-3)),
        beta1=float(cfg_get(c, "beta1", 0.9)),
        beta2=float(cfg_get(c, "beta2", 0.99)),
        beta3=float(cfg_get(c, "beta3", 0.9)),
        beta_shampoo=float(cfg_get(c, "beta_shampoo", 0.9)),
        epsilon=float(cfg_get(c, "epsilon", 1e-8)),
        identity=float(cfg_get(c, "identity", 0.01)),
        l2_reg=float(cfg_get(c, "l2_reg", 1e-5)),
        relative_decay=float(cfg_get(c, "relative_decay", 0.0)),
        absolute_decay=float(cfg_get(c, "absolute_decay", 0.0)),
        cg_on_momentum=bool(cfg_get(c, "cg_on_momentum", True)),
        frobenius_normalization=bool(
            cfg_get(c, "frobenius_normalization", True)
        ),
    ),
)
register_optimizer(
    "SGD",
    lambda c: SGDOptimizer(
        learning_rate=float(cfg_get(c, "learning_rate", 1e-3)),
        l2_reg=float(cfg_get(c, "l2_reg", 1e-8)),
    ),
)
register_optimizer(
    "Novograd",
    lambda c: NovogradOptimizer(
        learning_rate=float(cfg_get(c, "learning_rate", 1e-3)),
        beta1=float(cfg_get(c, "beta1", 0.9)),
        beta2=float(cfg_get(c, "beta2", 0.999)),
        epsilon=float(cfg_get(c, "epsilon", 1e-8)),
        relative_decay=float(cfg_get(c, "relative_decay", 0.0)),
        absolute_decay=float(cfg_get(c, "absolute_decay", 0.0)),
    ),
)
register_optimizer(
    "EMA",
    lambda c: EmaOptimizer(_nested_of(c), decay=float(cfg_get(c, "decay", 0.99))),
)
register_optimizer(
    "Average",
    lambda c: AverageOptimizer(
        _nested_of(c), n_samples=int(cfg_get(c, "n_samples", 128))
    ),
)
register_optimizer(
    "Batched",
    lambda c: BatchedOptimizer(
        _nested_of(c),
        batch_size_multiplier=int(cfg_get(c, "batch_size_multiplier", 16)),
    ),
)
register_optimizer(
    "Lookahead",
    lambda c: LookaheadOptimizer(
        _nested_of(c),
        alpha=float(cfg_get(c, "alpha", 0.5)),
        n_steps=int(cfg_get(c, "n_steps", 16)),
    ),
)
register_optimizer(
    "ExponentialDecay",
    lambda c: ExponentialDecayOptimizer(
        _nested_of(c),
        decay_base=float(cfg_get(c, "decay_base", 0.1)),
        decay_start=int(cfg_get(c, "decay_start", 10000)),
        decay_end=int(cfg_get(c, "decay_end", 10000000)),
        decay_interval=int(cfg_get(c, "decay_interval", 10000)),
    ),
)


def _make_composite_optimizer(c):
    nested_cfgs = cfg_get(c, "nested")
    if not isinstance(nested_cfgs, (list, tuple)) or not nested_cfgs:
        raise ValueError("Must provide an array of nested optimizers to Composite")
    nested = [create_optimizer(n) for n in nested_cfgs]
    declared = [
        cfg_get(n, "n_params_to_optimize", None) for n in nested_cfgs
    ]
    return CompositeOptimizer(nested, declared)


register_optimizer("Composite", _make_composite_optimizer)
