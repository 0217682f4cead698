"""Multi-chip data parallelism.

The reference is strictly single-GPU (SURVEY.md 2.9: no distributed backend
of any kind). This module is the NEW capability this framework adds: the
sample/ray batch - the reference's only "long axis" - is sharded across a
1-D `jax.sharding.Mesh` ('data' axis; on one host the cards reach each other
all to all over NVLink), parameters are replicated, and the per-shard
parameter gradients are mean-reduced with `pmean` inside a `shard_map`ped
step, which XLA hands to NCCL. XLA's latency-hiding scheduler overlaps the
all-reduce with the remaining backward computation (the analog of the
reference's wgrad-on-forked-streams overlap, fully_fused_mlp.cu:784-828).

Every shard applies the same reduced gradient, so the replicas stay
identical. The per-shard grid-table gradients are scatter-adds that XLA
lowers to atomics on a GPU, so their last bits can vary from run to run.

Usage:
    mesh = create_mesh()                     # all visible devices
    dp = DataParallelTrainer(trainer, mesh)
    state = dp.replicate(trainer.state)
    state, loss = dp.step(state, x, y)       # x, y sharded on axis 0
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def create_mesh(devices=None, axis_name: str = "data") -> Mesh:
    """1-D mesh over all (or the given) devices."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (axis_name,))


class DataParallelTrainer:
    """Wraps a Trainer's pure step with batch sharding + grad all-reduce."""

    def __init__(self, trainer, mesh: Mesh, axis_name: str = "data"):
        self.trainer = trainer
        self.mesh = mesh
        self.axis = axis_name
        n_dev = mesh.devices.size

        replicated = NamedSharding(mesh, P())
        batch_sharded = NamedSharding(mesh, P(axis_name))

        def make_step(with_pdf):
            def shard_fn(state, inputs, targets, pdf=None):
                # per-shard loss normalizes by the LOCAL batch; pmean restores
                # the reference's global-batch 1/n_total semantics
                rng = jax.random.fold_in(
                    state["rng"], jax.lax.axis_index(axis_name)
                )
                loss_value, grads = trainer.loss_and_grad_fn(
                    state["params"], inputs, targets, pdf, rng
                )
                grads = jax.lax.pmean(grads, axis_name)
                loss_value = jax.lax.pmean(loss_value, axis_name)
                # optimizer runs replicated (identical on every shard)
                opt_state, params = trainer.optimizer.step(
                    state["opt"], trainer.loss_scale, state["params"], grads
                )
                new_rng = jax.random.split(state["rng"])[0]
                return (
                    {"params": params, "opt": opt_state, "rng": new_rng},
                    loss_value,
                )

            data_specs = (P(axis_name),) * (3 if with_pdf else 2)

            def step(state, *data):
                return jax.shard_map(
                    shard_fn,
                    mesh=mesh,
                    in_specs=(P(),) + data_specs,
                    out_specs=(P(), P()),
                    check_vma=False,
                )(state, *data)

            return step

        def ext_shard_fn(state, inputs, dL_doutput):
            # external-gradient step (trainer.h:127-131): backward from a
            # caller-provided dL_doutput instead of a loss
            grads = trainer.external_grad_fn(
                state["params"], inputs, dL_doutput
            )
            # external grads are unnormalized per-sample sums (the caller
            # owns any normalization via dL_doutput) -> psum, not pmean
            grads = jax.lax.psum(grads, axis_name)
            opt_state, params = trainer.optimizer.step(
                state["opt"], trainer.loss_scale, state["params"], grads
            )
            new_rng = jax.random.split(state["rng"])[0]
            return {"params": params, "opt": opt_state, "rng": new_rng}

        def ext_step(state, inputs, dL_doutput):
            return jax.shard_map(
                ext_shard_fn,
                mesh=mesh,
                in_specs=(P(), P(axis_name), P(axis_name)),
                out_specs=P(),
                check_vma=False,
            )(state, inputs, dL_doutput)

        # Steps are jitted LAZILY, keyed on the trainer's trace-baked
        # values (max_level schedule, perturbation sigma) - same retrace
        # semantics as Trainer._get_jitted, so a change between steps
        # can't silently keep a stale compiled step.
        self._fns = {
            "step": make_step(True),
            "step_nopdf": make_step(False),
            "step_ext": ext_step,
        }
        self._jitted = {}
        self._replicated = replicated
        self._batch_sharded = batch_sharded
        self._n_dev = n_dev

    def _jit_for(self, name):
        key = (name, self.trainer._trace_baked_key())
        if key not in self._jitted:
            self._jitted[key] = jax.jit(self._fns[name])
        return self._jitted[key]

    def replicate(self, state):
        return jax.device_put(state, self._replicated)

    def shard_batch(self, *arrays):
        return tuple(jax.device_put(a, self._batch_sharded) for a in arrays)

    def step(self, state, inputs, targets, pdf=None):
        if pdf is None:
            inputs, targets = self.shard_batch(inputs, targets)
            return self._jit_for("step_nopdf")(state, inputs, targets)
        inputs, targets, pdf = self.shard_batch(inputs, targets, pdf)
        return self._jit_for("step")(state, inputs, targets, pdf)

    def step_external(self, state, inputs, dL_doutput):
        """Training step from a caller-provided dL_doutput (the reference's
        external-gradient mode, trainer.h:127-131), batch-sharded with a
        psum (unnormalized-sum) gradient reduction - external dL_doutput
        carries the caller's own normalization, unlike the loss path's
        per-sample mean. Returns the new state (no loss)."""
        inputs, dL_doutput = self.shard_batch(inputs, dL_doutput)
        return self._jit_for("step_ext")(state, inputs, dL_doutput)
