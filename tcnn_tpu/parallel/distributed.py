"""Multi-host distributed entry points (NEW capability vs the reference).

The reference is strictly single-GPU (SURVEY.md 2.9/5.8). Here the scaling
story is data parallelism over many hosts: every host runs this same
program, `init_distributed` wires the processes into one JAX runtime, a
global `Mesh` spans all devices, and `DataParallelTrainer.step` (shard_map +
pmean) runs unchanged - every host applies the same reduced gradient, so
every host steps identically.

Per-host input pipeline: each host generates ITS OWN shard of the global
batch on-device (the reference regenerates random batches per step on the
single GPU, mlp_learning_an_image.cu:258; over a host link, host-side
generation would starve the devices). `host_shard_key` folds the host's process index into the step
key so shards are disjoint, and `global_batch` assembles the process-local
shard into a global jax.Array without any cross-host data movement.

Tested with 2 processes x 4 virtual CPU devices via gloo collectives
(tests/test_multihost.py) - the same code path jax uses for real pod
slices.
"""

from __future__ import annotations

import os

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    local_device_ids=None,
) -> tuple[int, int]:
    """Initialize JAX's multi-process runtime; returns (process_id, count).

    All arguments default to the standard cluster environment variables
    (JAX_COORDINATOR_ADDRESS etc.), or to what jax.distributed detects
    from a cluster scheduler. A no-op when the
    runtime is already initialized or when running single-process with no
    coordinator configured.
    """
    try:
        from jax._src import distributed as _jd

        already = getattr(_jd.global_state, "client", None) is not None
    except Exception:
        already = False
    if not already:
        # NOTE: nothing here may touch the backend (jax.devices,
        # jax.default_backend, ...) before initialize() - that would boot
        # the single-process runtime and make initialization fail.
        has_env = coordinator_address or os.environ.get(
            "JAX_COORDINATOR_ADDRESS"
        ) or os.environ.get("COORDINATOR_ADDRESS")
        if has_env or num_processes is not None:
            jax.distributed.initialize(
                coordinator_address=coordinator_address,
                num_processes=num_processes,
                process_id=process_id,
                local_device_ids=local_device_ids,
            )
        else:
            # bare initialize() auto-configures under cluster schedulers
            # (SLURM, Open MPI); harmless no-op failure elsewhere
            try:
                jax.distributed.initialize()
            except Exception:
                pass
    return jax.process_index(), jax.process_count()


def global_mesh(axis_name: str = "data") -> Mesh:
    """1-D data mesh over ALL devices of ALL processes."""
    return Mesh(np.asarray(jax.devices()).reshape(-1), (axis_name,))


def host_shard_key(key, step_or_unique=0):
    """Per-host RNG key: disjoint streams per (host, step) so each host
    generates a distinct shard of the global batch (SURVEY.md 5.7)."""
    key = jax.random.fold_in(key, jax.process_index())
    return jax.random.fold_in(key, step_or_unique)


def global_batch(mesh: Mesh, local_arrays, global_batch_size: int,
                 axis_name: str = "data"):
    """Assemble per-host on-device shards into global batch-sharded
    jax.Arrays (no cross-host transfer; each host contributes the rows its
    own devices hold)."""
    sharding = NamedSharding(mesh, P(axis_name))
    out = []
    for a in local_arrays:
        gshape = (global_batch_size,) + tuple(a.shape[1:])
        out.append(
            jax.make_array_from_process_local_data(sharding, np.asarray(a),
                                                   gshape)
        )
    return tuple(out)
