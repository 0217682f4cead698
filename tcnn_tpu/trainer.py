"""Trainer: owns model + optimizer + loss; jitted fused training step.

Mirror of Trainer<T, PARAMS_T, COMPUTE_T>
(/root/reference/include/tiny-cuda-nn/trainer.h:47-361). The reference
CUDA-graph-captures {forward, loss, backward} and launches a fused optimizer
kernel (trainer.h:163-190); here the *entire* training step - forward,
loss, backward, optimizer - is one `jax.jit` program, which is strictly more
fused (XLA also folds the fp32->bf16 param cast and the loss reduction in).

State is a pytree {params (flat fp32 master), opt (optimizer state), rng}:
the analog of the reference's single param buffer (fp32 master + compute copy
+ grads, trainer.h:75,322-336). The bf16 compute copy is materialized inside
the step by XLA; gradients are produced by jax.value_and_grad instead of
hand-written backward kernels.

Feature parity:
  - loss_scale multiplied into the loss before grad, divided out in the
    optimizer (common.h:229-233, adam.h:75)
  - data_pdf support, external dL_doutput (trainer.h:127-131)
  - output perturbation with logistic noise (trainer.h:114-121)
  - custom (EMA/Average/Lookahead) weights used for inference
    (trainer.h:329-333)
  - serialize/deserialize with optional optimizer state (trainer.h:275-315)
  - update_hyperparams with live loss swap / optimizer lr updates
    (trainer.h:213-224)
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np

from .common import COMPUTE_DTYPE, default_loss_scale
from .utils.serialization import array_from_json, array_to_json, tree_from_json, tree_to_json


class Trainer:
    def __init__(
        self,
        model,
        optimizer,
        loss,
        seed: int = 1337,
        compute_dtype=COMPUTE_DTYPE,
        loss_scale: float | None = None,
        perturbation_sigma: float = 0.0,
    ):
        self.model = model
        self.optimizer = optimizer
        self.loss_fn = loss
        self.compute_dtype = compute_dtype
        self.loss_scale = (
            default_loss_scale(compute_dtype) if loss_scale is None else loss_scale
        )
        self.perturbation_sigma = float(perturbation_sigma)

        self.optimizer.allocate(model.n_params, model.layer_sizes())

        key = jax.random.PRNGKey(seed)
        k_init, k_rng = jax.random.split(key)
        self.state = {
            "params": jnp.asarray(model.init_params(k_init), jnp.float32),
            "opt": self.optimizer.init_state(),
            "rng": k_rng,
        }
        self._jitted = {}

    # ------------------------------------------------------------------
    # Functional core (pure; safe to wrap in shard_map / pjit)
    # ------------------------------------------------------------------
    def loss_and_grad_fn(self, params, inputs, targets, pdf, rng):
        """Returns (loss_value, grads); grads carry loss_scale (reference
        convention; the optimizer divides it back out)."""
        def f(p):
            out = self.model.apply(p, inputs, compute_dtype=self.compute_dtype)
            if self.perturbation_sigma > 0:
                # trainer.h:114-121: logistic-noise dithering of the output
                u = jax.random.uniform(
                    rng, out.shape, minval=1e-6, maxval=1.0 - 1e-6
                )
                noise = self.perturbation_sigma * jnp.log(u / (1.0 - u))
                out = out + noise.astype(out.dtype)
            values = self.loss_fn(out, targets, pdf)
            total = jnp.sum(values.astype(jnp.float32))
            return self.loss_scale * total, total

        (_, loss_value), grads = jax.value_and_grad(f, has_aux=True)(params)
        return loss_value, grads

    def external_grad_fn(self, params, inputs, dL_doutput):
        """Backward from a caller-provided dL_doutput (trainer.h:127-131)."""
        def f(p):
            return self.model.apply(p, inputs, compute_dtype=self.compute_dtype)

        out, vjp = jax.vjp(f, params)
        (grads,) = vjp(dL_doutput.astype(out.dtype))
        return grads

    def train_step_fn(self, state, inputs, targets, pdf=None, dL_doutput=None):
        """Pure training step: returns (new_state, loss_value)."""
        rng, rng_next = jax.random.split(state["rng"])
        if dL_doutput is not None:
            grads = self.external_grad_fn(state["params"], inputs, dL_doutput)
            loss_value = jnp.zeros((), jnp.float32)
        else:
            loss_value, grads = self.loss_and_grad_fn(
                state["params"], inputs, targets, pdf, rng
            )
        opt_state, params = self.optimizer.step(
            state["opt"], self.loss_scale, state["params"], grads
        )
        return {"params": params, "opt": opt_state, "rng": rng_next}, loss_value

    # ------------------------------------------------------------------
    # Stateful convenience API
    # ------------------------------------------------------------------
    def _trace_baked_key(self):
        """Mutable model attributes that are baked in at trace time (python
        scalars read during tracing). Including them in the jit-cache key
        makes e.g. a coarse-to-fine max_level schedule (mutated via
        GridEncoding.update_hyperparams between steps) take effect without
        an explicit trainer.invalidate() - the reference treats max_level
        as a per-launch runtime value (grid.h:236-240).

        max_level is keyed by the DERIVED number of active levels, not the
        raw float: every consumer (`_mask_max_level`) only reads
        `level < max_level*L + 1e-3`, so floats with the same active-level
        count compile to semantically identical programs. A continuous
        coarse-to-fine schedule therefore retraces at most n_levels+1 times
        instead of once per distinct float."""
        enc = getattr(self.model, "encoding", self.model)
        ml = getattr(enc, "max_level", None)
        if ml is None:
            ml_key = None
        else:
            L = int(getattr(enc, "n_levels", 1))
            ml_key = sum(1 for l in range(L) if l < float(ml) * L + 1e-3)
        return (ml_key, self.perturbation_sigma)

    def _get_jitted(self, name, fn, **jit_kwargs):
        key = (name, self._trace_baked_key())
        if key not in self._jitted:
            self._jitted[key] = jax.jit(fn, **jit_kwargs)
        return self._jitted[key]

    def invalidate(self):
        """Drop compiled artifacts (after update_hyperparams)."""
        self._jitted.clear()

    def training_step(self, inputs, targets=None, pdf=None, dL_doutput=None):
        """Run one step; updates self.state; returns loss as a device scalar
        (read it lazily - forcing it each step adds a device sync, which the
        reference also warns about, trainer.h:205-207)."""
        if dL_doutput is not None:
            step = self._get_jitted(
                "train_ext",
                lambda s, i, g: self.train_step_fn(s, i, None, None, g),
                donate_argnums=(0,),
            )
            self.state, loss_value = step(self.state, inputs, dL_doutput)
        elif pdf is not None:
            step = self._get_jitted(
                "train_pdf",
                lambda s, i, t, p: self.train_step_fn(s, i, t, p),
                donate_argnums=(0,),
            )
            self.state, loss_value = step(self.state, inputs, targets, pdf)
        else:
            step = self._get_jitted(
                "train",
                lambda s, i, t: self.train_step_fn(s, i, t),
                donate_argnums=(0,),
            )
            self.state, loss_value = step(self.state, inputs, targets)
        return loss_value

    @property
    def params(self):
        return self.state["params"]

    @property
    def inference_params(self):
        """Custom (EMA/averaged) weights when the optimizer provides them
        (trainer.h:329-333), else the live params."""
        cw = self.optimizer.custom_weights(self.state["opt"], self.state["params"])
        return self.state["params"] if cw is None else cw

    def set_params(self, params) -> None:
        params = jnp.asarray(params, jnp.float32)
        if params.shape != self.state["params"].shape:
            raise ValueError(
                f"expected {self.state['params'].shape} params, got {params.shape}"
            )
        self.state["params"] = params

    # full-precision alias (the reference distinguishes fp32/half setters,
    # trainer.h:242-269; our master params are always fp32)
    set_params_full_precision = set_params

    def forward(self, inputs, targets=None, pdf=None, use_inference_params=False):
        """Forward + loss values (the reference's Trainer::forward,
        trainer.h:97-141). Returns a ctx dict.

        Like the reference, output perturbation (logistic noise, sigma =
        perturbation_sigma, trainer.h:114-121) is applied here too - so a
        loss computed from forward() matches what training_step sees."""
        params = self.inference_params if use_inference_params else self.params

        def _fwd(p, i, rng):
            out = self.model.apply(p, i, compute_dtype=self.compute_dtype)
            if self.perturbation_sigma > 0:
                u = jax.random.uniform(
                    rng, out.shape, minval=1e-6, maxval=1.0 - 1e-6
                )
                noise = self.perturbation_sigma * jnp.log(u / (1.0 - u))
                out = out + noise.astype(out.dtype)
            return out

        def _fwd_loss(p, i, t, pdf_, rng):
            """Forward + in-graph loss evaluation: the reference fuses the
            loss kernel into Trainer::forward (trainer.h:97-141); here the
            whole thing is one jit program instead of an eager tail."""
            out = _fwd(p, i, rng)
            return out, self.loss_fn(out, t, pdf_)

        rng = self.state["rng"]
        if self.perturbation_sigma > 0:
            rng, rng_next = jax.random.split(rng)
            self.state["rng"] = rng_next
        if targets is None:
            out = self._get_jitted("forward", _fwd)(params, inputs, rng)
            return {"output": out}
        name = "forward_loss" if pdf is not None else "forward_loss_nopdf"
        fwd = self._get_jitted(
            name,
            _fwd_loss if pdf is not None
            else (lambda p, i, t, rng: _fwd_loss(p, i, t, None, rng)),
        )
        args = (params, inputs, targets) + (
            (pdf, rng) if pdf is not None else (rng,)
        )
        out, loss_values = fwd(*args)
        return {"output": out, "loss_values": loss_values}

    def loss(self, ctx) -> float:
        """Host float of the summed loss (trainer.h:205-207; syncs)."""
        return float(jnp.sum(ctx["loss_values"]))

    def inference(self, inputs):
        """fp32 output trimmed to n_output_dims (object.h:147-179)."""
        fn = self._get_jitted(
            "inference",
            lambda p, i: self.model.apply(
                p, i, compute_dtype=self.compute_dtype
            )[:, : self.model.n_output_dims].astype(jnp.float32),
        )
        return fn(self.inference_params, inputs)

    # ------------------------------------------------------------------
    # Hyperparams / checkpointing
    # ------------------------------------------------------------------
    def update_hyperparams(self, params: dict) -> None:
        # trainer.h:213-224
        if "optimizer" in params:
            self.optimizer.update_hyperparams(params["optimizer"])
        if "loss" in params:
            from .registry import create_loss

            self.loss_fn = create_loss(params["loss"])
        self.invalidate()

    def serialize(self, serialize_optimizer: bool = True) -> dict:
        """JSON-compatible snapshot (trainer.h:275-288)."""
        data = {
            "n_params": int(self.model.n_params),
            "params_type": "float",
            "params_binary": array_to_json(np.asarray(self.state["params"])),
        }
        if serialize_optimizer:
            data["optimizer"] = {
                "hyperparams": self.optimizer.hyperparams(),
                "state": tree_to_json(self.state["opt"]),
            }
        return data

    def deserialize(self, data: dict) -> None:
        """Restore from `serialize` output (trainer.h:290-315).

        Like the reference, accepts both "float" and "__half" snapshots
        (trainer.h:292-305): a __half snapshot's raw little-endian fp16
        buffer is upcast to the fp32 master params. The reference's raw
        param buffer layout ([network weights..., encoding table...]) is
        the same flat vector this Trainer uses."""
        ptype = data.get("params_type", "float")
        if ptype not in ("float", "__half"):
            raise ValueError(
                "Trainer: snapshot parameters must be of type float or __half"
            )
        blob = data["params_binary"]
        if isinstance(blob, dict) and "data" in blob:
            params = array_from_json(blob)  # dtype tag honored (f2 or f4)
        elif isinstance(blob, (list, bytes, bytearray)):
            # nlohmann::json binary_t round-tripped through text JSON is a
            # plain little-endian byte list (gpu_memory_json.h:37-72)
            dt = np.float16 if ptype == "__half" else np.float32
            params = np.frombuffer(bytes(blob), dtype=dt)
        else:
            raise ValueError("unrecognized params_binary format")
        self.set_params(np.asarray(params, np.float32))
        if "optimizer" in data and data["optimizer"] is not None:
            self.state["opt"] = tree_from_json(
                data["optimizer"]["state"], self.state["opt"]
            )

    def save(self, path: str, serialize_optimizer: bool = True) -> None:
        with open(path, "w") as f:
            json.dump(self.serialize(serialize_optimizer), f)

    def load(self, path: str) -> None:
        with open(path) as f:
            self.deserialize(json.load(f))

    # -- orbax backend (sharded/async-capable checkpoints for multi-host) --
    def save_orbax(self, path: str) -> None:
        """Checkpoint the full training state with orbax (works with sharded
        multi-host state, unlike the JSON snapshot which gathers to host)."""
        with _orbax_checkpointer() as ckptr:
            ckptr.save(path, self.state, force=True)

    def load_orbax(self, path: str) -> None:
        with _orbax_checkpointer() as ckptr:
            self.state = ckptr.restore(path, self.state)


def _orbax_checkpointer():
    try:
        import orbax.checkpoint as ocp
    except ImportError as e:
        raise ImportError(
            "save_orbax/load_orbax need the orbax-checkpoint package "
            "(pip install orbax-checkpoint)"
        ) from e
    return ocp.StandardCheckpointer()
