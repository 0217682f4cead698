#!/usr/bin/env python3
"""Smoke test of tcnn_tpu on NVIDIA GPUs: the quickest proof that the
system still starts, trains and computes right on the card.

    python3 chip_smoke.py               # one card: phases a-e below
    python3 chip_smoke.py --four-cards  # DataParallelTrainer on 4 cards

One card:
  a. the device: JAX's platform, kind and count; the card's name and power
     limit from nvidia-smi;
  b. config_hash (HashGrid L16/F2/T2^15 + FullyFusedMLP 64x2, RelativeL2,
     Adam) at batch 2^18 through Trainer.training_step / Trainer.inference:
     cold compile, 200 steps whose loss must fall 10x, training and
     inference samples/s, compiled and peak memory, the MLP's route;
  c. parity at real widths against the numpy references of
     tcnn_tpu/reference.py: the grid forward and table gradient at 2^18
     samples, and FullyFusedMLP forward, dW and dx at 2^18 x 64;
  d. short runs whose loss must stay finite and fall: the reference-default
     table (T=2^19, scale 2), second-order eikonal SDF training, and
     PPNG1/2/3 at their factory defaults;
  e. the fused MLP kernel against XLA's CutlassMLP chain, train step and
     inference, at config_hash and config_oneblob, in turns A, B, B, A.

--four-cards runs only DataParallelTrainer at config_hash with 2^18 rows
per card for 20 steps beside one card at the same global batch, and checks
that the two loss curves agree.

Every phase prints one JSON object on its own line, naming the card and its
power limit. Any failed check raises and the script exits non-zero; the last
line, printed only when every phase passed, is
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
Without a GPU it exits non-zero at once.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "samples"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import tcnn_tpu as tc  # noqa: E402
from bench import inference_loop  # noqa: E402
from tcnn_tpu import reference  # noqa: E402
from tcnn_tpu.utils.device import (  # noqa: E402
    NoGpuError,
    device_info,
    nvidia_smi,
    require_gpu,
)
from tcnn_tpu.utils.image import sample_image, synthetic_image  # noqa: E402

BATCH = 1 << 18
#: MLP parity: relative L2 bound for the forward output and dW (bf16
#: operands, fp32 accumulation); dx is bounded by XLA's own bf16 chain,
#: see PERF.md "Parity tolerances"
MLP_TOL = 2e-2
GRID_FWD_TOL = 1e-5
GRID_GRAD_TOL = 1e-5
DP_LOSS_TOL = 1e-3

DEVICE = {}


def emit(phase, **fields):
    rec = {"phase": phase, "card": DEVICE["card"],
           "power_limit_w": DEVICE["power_limit_w"], **fields}
    print(json.dumps(rec), flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def rel_l2(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def load_config(name):
    return tc.load_config(os.path.join(ROOT, "data", name))


def image_batches(n, batch, n_dims=2, seed=0):
    """n (x, target) pairs made on the device from a synthetic image."""
    image = jnp.asarray(synthetic_image(1024, 1024))
    make = jax.jit(
        lambda k: (lambda x: (x, sample_image(image, x[:, :2])))(
            jax.random.uniform(k, (batch, n_dims))
        )
    )
    keys = jax.random.split(jax.random.PRNGKey(seed), n)
    return [make(k) for k in keys]


def timed_steps(trainer, batches, n_steps):
    """(seconds, losses) of n_steps training_step calls cycling batches."""
    jax.block_until_ready(trainer.training_step(*batches[0]))
    t0 = time.perf_counter()
    losses = [trainer.training_step(*batches[i % len(batches)])
              for i in range(n_steps)]
    jax.block_until_ready(losses[-1])
    return time.perf_counter() - t0, losses


def inference_rate(model, x, n_per_call=10, n_calls=50):
    infer = inference_loop(model.network, n_per_call)
    params = model.trainer.inference_params
    xc = x
    for _ in range(5):  # compile, then warm the card's clocks
        xc, last = infer(params, xc)
    jax.block_until_ready(last)
    t0 = time.perf_counter()
    for _ in range(n_calls):
        xc, last = infer(params, xc)
    jax.block_until_ready(last)
    check(bool(jnp.isfinite(last)), "inference output not finite")
    return n_per_call * n_calls * x.shape[0] / (time.perf_counter() - t0)


def falling(losses, what, factor=1.0):
    """Losses must be finite and the last below first / factor."""
    ls = [float(v) for v in losses]
    check(all(np.isfinite(ls)), f"{what}: loss not finite: {ls}")
    check(ls[-1] * factor < ls[0],
          f"{what}: loss {ls[0]:.4e} -> {ls[-1]:.4e} did not fall {factor}x")
    return ls


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_config_hash():
    model = tc.create_from_config(2, 3, load_config("config_hash.json"))
    tr = model.trainer
    batches = image_batches(8, BATCH)
    t0 = time.perf_counter()
    jax.block_until_ready(tr.training_step(*batches[0]))
    compile_s = time.perf_counter() - t0
    seconds, losses = timed_steps(tr, batches, 200)
    ls = falling(losses, "config_hash 200 steps", factor=10.0)
    x_inf = jax.random.uniform(jax.random.PRNGKey(7), (BATCH, 2))
    t0 = time.perf_counter()
    out = tr.inference(x_inf)
    jax.block_until_ready(out)
    infer_compile_s = time.perf_counter() - t0
    check(out.shape == (BATCH, 3) and bool(jnp.all(jnp.isfinite(out))),
          "inference output shape or values")
    compiled = (
        jax.jit(tr.train_step_fn).lower(tr.state, *batches[0]).compile()
    )
    mem = compiled.memory_analysis()
    emit(
        "config_hash",
        batch=BATCH,
        mlp_route=model.network.network.route,
        compile_s=compile_s,
        inference_compile_s=infer_compile_s,
        compilation_cache=tc.utils.compile_cache.cache_dir(),
        loss_first=ls[0],
        loss_last=ls[-1],
        train_samples_per_s=200 * BATCH / seconds,
        train_step_ms=seconds / 200 * 1e3,
        inference_samples_per_s=inference_rate(model, x_inf),
        step_memory_bytes={
            "argument": mem.argument_size_in_bytes,
            "output": mem.output_size_in_bytes,
            "temp": mem.temp_size_in_bytes,
            "generated_code": mem.generated_code_size_in_bytes,
        },
        peak_bytes_in_use=(jax.devices()[0].memory_stats() or {}).get(
            "peak_bytes_in_use"),
    )
    return model


def phase_parity(model):
    enc = model.network.encoding
    rng = np.random.default_rng(0)
    x = rng.uniform(0.0, 1.0, (BATCH, 2)).astype(np.float32)
    params = rng.uniform(-1.0, 1.0, enc.n_params).astype(np.float32)
    dy = rng.normal(size=(BATCH, enc.n_output_dims)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        y = jax.jit(
            lambda p, xx: enc.apply_unpadded(p, xx, compute_dtype=jnp.float32)
        )(params, x)
        g = jax.jit(jax.grad(
            lambda p, xx: jnp.sum(
                enc.apply_unpadded(p, xx, compute_dtype=jnp.float32) * dy
            )
        ))(params, x)
    # the position x * scale + 0.5 may be rounded once (tiny-cuda-nn's
    # fmaf) or twice; check against both and hold the closer to the bound
    grid_fwd, grid_grad = {}, {}
    for name, fma in (("fma", True), ("mul_add", False)):
        y_ref = reference.grid_encode(enc, params, x, fma=fma)
        g_ref = reference.grid_table_grad(enc, x, dy, fma=fma)
        grid_fwd[name] = float(
            np.abs(np.asarray(y) - y_ref).max() / np.abs(y_ref).max())
        grid_grad[name] = rel_l2(g, g_ref)

    mlp = model.network.network
    w_in = mlp.input_width
    xm = jnp.asarray(rng.uniform(0.0, 1.0, (BATCH, w_in)), jnp.bfloat16)
    pm = jnp.asarray(mlp.init_params(jax.random.PRNGKey(3)))
    # a positive cotangent, so dW sums are coherent and the bound tests
    # the kernel, not bf16 noise on a random walk (PERF.md)
    rows = np.arange(BATCH)[:, None] * 1e-3
    dym = (1.0 + 0.5 * np.cos(rows + np.arange(mlp.padded_output_width)))
    dym = dym.astype(np.float32)

    def grads(apply):
        f = jax.jit(jax.value_and_grad(
            lambda p, xx: jnp.sum(apply(p, xx).astype(jnp.float32) * dym),
            argnums=(0, 1),
        ))
        fwd = jax.jit(apply)
        return (fwd(pm, xm),) + f(pm, xm)[1]

    ym, dwm, dxm = grads(lambda p, xx: mlp.apply(p, xx))
    chain = tc.models.mlp.CutlassMLP.apply
    _, _, dx_xla = grads(lambda p, xx: chain(mlp, p, xx))
    y_r, dw_r, dx_r = reference.mlp_forward_backward(
        mlp, np.asarray(pm), np.asarray(xm.astype(jnp.float32)), dym
    )
    err = {"y": rel_l2(ym, y_r), "dW": rel_l2(dwm, dw_r),
           "dx": rel_l2(dxm, dx_r), "dx_xla_bf16_chain": rel_l2(dx_xla, dx_r)}
    emit("parity", grid_batch=BATCH, grid_fwd_max_rel=grid_fwd,
         grid_table_grad_rel_l2=grid_grad, mlp_route=mlp.route,
         mlp_shape=[BATCH, mlp.n_neurons], mlp_rel_l2=err)
    rounding = min(grid_fwd, key=grid_fwd.get)
    check(grid_fwd[rounding] <= GRID_FWD_TOL, f"grid forward {grid_fwd}")
    check(grid_grad[rounding] <= GRID_GRAD_TOL,
          f"grid table gradient {grid_grad}")
    check(err["y"] <= MLP_TOL and err["dW"] <= MLP_TOL, f"mlp {err}")
    check(err["dx"] <= 1.1 * err["dx_xla_bf16_chain"] + 1e-3, f"mlp dx {err}")


def phase_short_runs():
    cfg = load_config("config_hash.json")
    cfg["encoding"] = dict(cfg["encoding"], log2_hashmap_size=19,
                           per_level_scale=2.0)
    model = tc.create_from_config(2, 3, cfg)
    _, losses = timed_steps(model.trainer, image_batches(4, BATCH, seed=1), 20)
    ls = falling(losses, "T=2^19")
    emit("table_2^19", steps=20, batch=BATCH, loss_first=ls[0],
         loss_last=ls[-1])

    from learn_a_sdf import make_train_step, sdf_config

    model = tc.create_from_config(3, 1, sdf_config("HashGrid"))
    step = make_train_step(model)
    state, losses = model.trainer.state, []
    for _ in range(20):
        state, lv = step(state)
        losses.append(lv)
    ls = falling(losses, "eikonal SDF")
    emit("eikonal_sdf", steps=20, loss_first=ls[0], loss_last=ls[-1])

    base = load_config("config_hash.json")
    for otype in ("PPNG1", "PPNG2", "PPNG3"):
        cfg = dict(base, encoding={"otype": otype})
        model = tc.create_from_config(3, 3, cfg)
        batches = image_batches(2, BATCH // 2, n_dims=3, seed=2)
        t0 = time.perf_counter()
        _, losses = timed_steps(model.trainer, batches, 10)
        ls = falling(losses, otype)
        emit(otype.lower(), steps=10, batch=BATCH // 2, loss_first=ls[0],
             loss_last=ls[-1], seconds_incl_compile=time.perf_counter() - t0)


def phase_mlp_ab():
    """Fused kernel (FullyFusedMLP) vs XLA's chain (CutlassMLP, same
    parameters) in one process, in turns A, B, B, A."""
    for name in ("config_hash.json", "config_oneblob.json"):
        cfg = load_config(name)
        models = {}
        for otype in ("CutlassMLP", "FullyFusedMLP"):
            c = dict(cfg, network=dict(cfg["network"], otype=otype))
            models[otype] = tc.create_from_config(2, 3, c)
        batches = image_batches(4, BATCH, seed=3)
        x_inf = batches[0][0]
        step_ms = {k: [] for k in models}
        infer = {k: [] for k in models}
        for k in ("CutlassMLP", "FullyFusedMLP", "FullyFusedMLP", "CutlassMLP"):
            seconds, losses = timed_steps(models[k].trainer, batches, 100)
            falling(losses, f"{name} {k}")
            step_ms[k].append(seconds / 100 * 1e3)
            infer[k].append(inference_rate(models[k], x_inf))
        emit("mlp_ab", config=name,
             route=models["FullyFusedMLP"].network.network.route,
             train_step_ms=step_ms, inference_samples_per_s=infer)


def loss_curve(step, n_steps):
    """(losses, steps/s): step(i) runs step i and returns its loss; the
    first step compiles and is left out of the rate."""
    losses = [step(0)]
    jax.block_until_ready(losses[0])
    t0 = time.perf_counter()
    losses += [step(i) for i in range(1, n_steps)]
    jax.block_until_ready(losses[-1])
    return [float(v) for v in losses], (n_steps - 1) / (time.perf_counter() - t0)


def phase_four_cards():
    from tcnn_tpu.parallel.data_parallel import DataParallelTrainer, create_mesh

    devices = jax.devices()
    check(len(devices) == 4, f"--four-cards needs 4 GPUs, JAX sees {len(devices)}")
    cfg = load_config("config_hash.json")
    glob = 4 * BATCH
    batches = image_batches(4, glob, seed=4)
    n_steps = 20

    single = tc.create_from_config(2, 3, cfg).trainer
    l_single, rate_single = loss_curve(
        lambda i: single.training_step(*batches[i % len(batches)]), n_steps
    )

    dp_trainer = tc.create_from_config(2, 3, cfg).trainer
    dp = DataParallelTrainer(dp_trainer, create_mesh(devices))
    sharded = [dp.shard_batch(x, t) for x, t in batches]
    state = [dp.replicate(dp_trainer.state)]

    def dp_step(i):
        state[0], lv = dp.step(state[0], *sharded[i % len(sharded)])
        return lv

    l_dp, rate_dp = loss_curve(dp_step, n_steps)
    rel = np.abs(np.asarray(l_dp) - l_single) / np.abs(l_single)
    emit("four_cards", per_card_batch=BATCH, global_batch=glob,
         steps=n_steps, dp_samples_per_s=rate_dp * glob,
         single_card_samples_per_s=rate_single * glob,
         max_rel_loss_diff=float(rel.max()), loss_dp=l_dp,
         loss_single=l_single)
    check(float(rel.max()) <= DP_LOSS_TOL, f"loss curves differ: {rel.max()}")


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--four-cards", action="store_true",
                        help="run only the 4-card data-parallel phase")
    args = parser.parse_args()

    try:
        require_gpu()
    except NoGpuError as e:
        sys.exit(f"chip_smoke.py: {e}")
    smi = nvidia_smi()
    DEVICE.update(device_info(smi))
    tc.enable_compilation_cache()
    print(smi.splitlines()[0], flush=True)
    emit("device", platform=DEVICE["platform"], kind=DEVICE["kind"],
         count=DEVICE["count"], nvidia_smi=smi)
    if args.four_cards:
        phase_four_cards()
    else:
        model = phase_config_hash()
        phase_parity(model)
        phase_short_runs()
        phase_mlp_ab()
    print(json.dumps({"ok": True, "device": {
        "platform": DEVICE["platform"], "kind": DEVICE["kind"],
        "count": DEVICE["count"]}}), flush=True)


if __name__ == "__main__":
    main()
