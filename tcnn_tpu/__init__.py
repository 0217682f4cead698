"""tcnn_tpu - a tiny-neural-network framework in JAX.

A from-scratch JAX/XLA/Pallas re-design with the capabilities of
tiny-cuda-nn (reference: leejaeyong7/tiny-cuda-nn, NVlabs v1.7 fork):
fully-fused tiny MLPs, multiresolution hash-grid encodings (Instant-NGP),
an encoding zoo, tcnn-exact losses and optimizers, a fused jitted trainer,
the JSON "otype" config system, and data-parallel multi-host scaling over
a `jax.sharding.Mesh`.
"""

__version__ = "0.1.0"

from .common import (  # noqa: F401
    Activation,
    BATCH_SIZE_GRANULARITY,
    GradientMode,
    GridType,
    HashType,
    InterpolationType,
    ReductionType,
    default_loss_scale,
)
from .config import (  # noqa: F401
    TrainableModel,
    create_from_config,
    create_network_with_input_encoding,
    load_config,
)
from .modules import Encoding, Network, NetworkWithInputEncoding  # noqa: F401
from .registry import (  # noqa: F401
    create_encoding,
    create_loss,
    create_network,
    create_optimizer,
    register_encoding,
    register_loss,
    register_network,
    register_optimizer,
)
from .trainer import Trainer  # noqa: F401
from .utils.compile_cache import enable_compilation_cache  # noqa: F401

batch_size_granularity = BATCH_SIZE_GRANULARITY  # cpp_api parity name

from .log import (  # noqa: F401
    LogSeverity,
    log,
    log_debug,
    log_error,
    log_info,
    log_success,
    log_warning,
    set_log_callback,
    set_verbose,
)
