"""Data-parallel (multi-chip) tests on the 8-device CPU mesh.

The reference has no distributed support at all (SURVEY.md 2.9); this is the
NEW capability of this framework. Checked here:
  - a sharded training step runs and reduces the loss
  - the pmean-reduced sharded gradients equal the single-device gradients
    at the same global batch, up to summation order
  - training trajectories match between 1-device and 8-device execution
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import tcnn_tpu as tc
from tcnn_tpu.parallel.data_parallel import DataParallelTrainer, create_mesh

CFG = {
    "loss": {"otype": "RelativeL2"},
    "optimizer": {"otype": "Adam", "learning_rate": 1e-2},
    "encoding": {
        "otype": "HashGrid",
        "n_levels": 4,
        "n_features_per_level": 2,
        "log2_hashmap_size": 10,
        "base_resolution": 4,
        "per_level_scale": 1.5,
    },
    "network": {"otype": "FullyFusedMLP", "n_neurons": 32, "n_hidden_layers": 2},
}


def _img(x):
    return jnp.stack(
        [jnp.sin(5 * x[:, 0]) * 0.5 + 0.5, x[:, 1], x[:, 0] * x[:, 1]], -1
    )


@pytest.fixture(scope="module")
def devices():
    ds = jax.devices()
    if len(ds) < 8:
        pytest.skip("needs 8 virtual devices")
    return ds[:8]


def test_sharded_step_reduces_loss(devices):
    mesh = create_mesh(devices)
    model = tc.create_from_config(2, 3, CFG)
    dp = DataParallelTrainer(model.trainer, mesh)
    state = dp.replicate(model.trainer.state)

    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.uniform(size=(1024, 2)), jnp.float32)
    t = _img(x)
    state, l0 = dp.step(state, x, t)
    for _ in range(20):
        state, loss = dp.step(state, x, t)
    assert float(loss) < float(l0) * 0.5


def test_sharded_matches_single_device(devices):
    """The pmean'd sharded step must produce the SAME trajectory as the
    plain single-device step at equal global batch: grid gradients are
    deterministic reductions, so this holds to f32 reduction-order noise."""
    mesh = create_mesh(devices)
    model_a = tc.create_from_config(2, 3, CFG)
    model_b = tc.create_from_config(2, 3, CFG)
    np.testing.assert_array_equal(
        np.asarray(model_a.trainer.state["params"]),
        np.asarray(model_b.trainer.state["params"]),
    )

    dp = DataParallelTrainer(model_a.trainer, mesh)
    state_sh = dp.replicate(model_a.trainer.state)

    rng = np.random.default_rng(1)
    for i in range(5):
        x = jnp.asarray(rng.uniform(size=(1024, 2)), jnp.float32)
        t = _img(x)
        state_sh, loss_sh = dp.step(state_sh, x, t)
        loss_1 = model_b.trainer.training_step(x, t)
        # per-shard 1/n_local normalization + pmean == global 1/n
        np.testing.assert_allclose(float(loss_sh), float(loss_1), rtol=1e-3)
        if i == 0:
            # after ONE step the parameters agree to f32 reduction-order
            # noise (the scatter itself is deterministic). Over longer
            # trajectories Adam's exact-zero lazy-skip rule (adam.h:77-84)
            # amplifies reduction-order flips of ~1e-12 grads into visible
            # per-param drift, so only the losses are compared there.
            np.testing.assert_allclose(
                np.asarray(state_sh["params"]),
                np.asarray(model_b.trainer.state["params"]),
                rtol=1e-3,
                atol=2e-5,
            )


def test_gradient_allclose_across_shardings(devices):
    """pmean of per-shard grads == global-batch grads (up to f32 order)."""
    mesh = create_mesh(devices)
    model = tc.create_from_config(2, 3, CFG)
    trainer = model.trainer

    rng = np.random.default_rng(2)
    x = jnp.asarray(rng.uniform(size=(2048, 2)), jnp.float32)
    t = _img(x)
    pdf = jnp.ones_like(t)
    key = jax.random.PRNGKey(0)

    _, g_global = trainer.loss_and_grad_fn(trainer.state["params"], x, t, pdf, key)

    from jax.sharding import PartitionSpec as P

    def shard_fn(params, xx, tt, pp):
        _, g = trainer.loss_and_grad_fn(params, xx, tt, pp, key)
        return jax.lax.pmean(g, "data")

    g_sharded = jax.jit(
        jax.shard_map(
            shard_fn,
            mesh=mesh,
            in_specs=(P(), P("data"), P("data"), P("data")),
            out_specs=P(),
            check_vma=False,
        )
    )(trainer.state["params"], x, t, pdf)

    ref = np.asarray(g_global)
    got = np.asarray(g_sharded)
    scale = max(np.abs(ref).max(), 1e-9)
    np.testing.assert_allclose(got / scale, ref / scale, atol=1e-5)


def test_external_dL_doutput_matches_single_device(devices):
    """DP external-gradient step (trainer.h:127-131): psum-reduced grads
    must equal the single-device external path on the same global batch
    (up to f32 summation order)."""
    from jax.sharding import PartitionSpec as P

    m = tc.create_from_config(2, 3, CFG)
    x = jax.random.uniform(jax.random.PRNGKey(3), (512, 2))
    dl = jax.random.normal(
        jax.random.PRNGKey(4), (512, m.network.padded_output_width)
    ) * 1e-2

    g_single = np.asarray(
        m.trainer.external_grad_fn(m.trainer.params, x, dl)
    )

    mesh = create_mesh(devices)

    def shard_fn(params, xx, ddl):
        g = m.trainer.external_grad_fn(params, xx, ddl)
        return jax.lax.psum(g, "data")

    g_dp = np.asarray(
        jax.jit(
            jax.shard_map(
                shard_fn, mesh=mesh,
                in_specs=(P(), P("data"), P("data")), out_specs=P(),
                check_vma=False,
            )
        )(m.trainer.params, x, dl)
    )
    scale = np.abs(g_single).max() + 1e-12
    np.testing.assert_allclose(g_dp / scale, g_single / scale, atol=2e-5)

    # and the step API runs + changes params
    dp = DataParallelTrainer(m.trainer, mesh)
    state = dp.replicate(m.trainer.state)
    state = dp.step_external(state, x, dl)
    assert not np.allclose(
        np.asarray(state["params"]), np.asarray(m.trainer.params)
    )


def test_dp_step_retraces_on_knob_flip(devices):
    """DataParallelTrainer must key its jitted steps on the trainer's
    trace-baked values (the coarse-to-fine max_level), so a change between
    steps retraces instead of silently keeping the old compiled step (same
    semantics as Trainer._get_jitted)."""
    mesh = create_mesh(devices)
    m = tc.create_from_config(2, 3, CFG)
    dp = DataParallelTrainer(m.trainer, mesh)
    state = dp.replicate(m.trainer.state)
    x = jax.random.uniform(jax.random.PRNGKey(10), (512, 2))
    t = _img(x)

    state, _ = dp.step(state, x, t)
    assert len(dp._jitted) == 1
    m.network.encoding.update_hyperparams({"max_level": 0.5})
    state, _ = dp.step(state, x, t)
    assert len(dp._jitted) == 2, "knob flip must produce a fresh trace"
    # flipping back reuses the first trace (no unbounded growth)
    m.network.encoding.update_hyperparams({"max_level": None})
    state, _ = dp.step(state, x, t)
    assert len(dp._jitted) == 2


def test_shampoo_under_mesh_matches_single_device(devices):
    """Shampoo (matrix preconditioner + lax.cond root
    refresh, shampoo.h:831-845 schedule) must run under the data-parallel
    mesh and reproduce the single-device trajectory. 12 steps cross the
    step-1 all-groups refresh AND a round-robin refresh (every 10 steps
    while step < 100), so the coupled-Newton inverse-root path executes
    replicated on all 8 devices."""
    cfg = dict(
        CFG,
        optimizer={"otype": "Shampoo", "learning_rate": 5e-3},
    )
    model_a = tc.create_from_config(2, 3, cfg)
    model_b = tc.create_from_config(2, 3, cfg)

    mesh = create_mesh(devices)
    dp = DataParallelTrainer(model_a.trainer, mesh)
    state_sh = dp.replicate(model_a.trainer.state)

    rng = np.random.default_rng(7)
    for i in range(12):
        x = jnp.asarray(rng.uniform(size=(1024, 2)), jnp.float32)
        t = _img(x)
        state_sh, loss_sh = dp.step(state_sh, x, t)
        loss_1 = model_b.trainer.training_step(x, t)
        np.testing.assert_allclose(
            float(loss_sh), float(loss_1), rtol=2e-3, err_msg=f"step {i}"
        )
    # the preconditioned trajectories stay together through both refresh
    # classes. Newton iterations + Adam-style lazy rules amplify f32
    # reduction-order noise chaotically on a FEW coordinates (measured
    # ~0.4% of params past 5% after 12 steps), so bound the bulk, not the
    # max: >= 99% of parameters within (rtol 5e-2 | atol 5e-4).
    p_sh = np.asarray(state_sh["params"])
    p_1 = np.asarray(model_b.trainer.state["params"])
    close = np.abs(p_sh - p_1) <= 5e-4 + 5e-2 * np.abs(p_1)
    assert np.mean(close) >= 0.99, f"only {np.mean(close):.4f} close"


def test_pdf_normalization_matches_single_device(devices):
    """Per-shard loss normalization + pmean must reproduce the
    single-device 1/n_total semantics even for pdf-weighted and
    Variance-style losses (gradients compared directly; post-Adam params
    amplify f32 summation-order noise)."""
    from jax.sharding import PartitionSpec as P

    mesh = create_mesh(devices)
    for otype in ["RelativeL2", "Variance", "CrossEntropy"]:
        cfg = dict(CFG, loss={"otype": otype})
        m = tc.create_from_config(2, 3, cfg)
        x = jax.random.uniform(jax.random.PRNGKey(5), (512, 2))
        t = jnp.abs(_img(x)) + 0.05
        pdf = jax.random.uniform(jax.random.PRNGKey(6), (512, 3)) + 0.5
        rng = jax.random.PRNGKey(0)

        loss_ref, g_ref = m.trainer.loss_and_grad_fn(
            m.trainer.params, x, t, pdf, rng
        )
        g_ref = np.asarray(g_ref)

        def shard_fn(params, xx, tt, pp):
            lv, g = m.trainer.loss_and_grad_fn(params, xx, tt, pp, rng)
            return jax.lax.pmean(lv, "data"), jax.lax.pmean(g, "data")

        loss_dp, g_dp = jax.jit(
            jax.shard_map(
                shard_fn, mesh=mesh,
                in_specs=(P(), P("data"), P("data"), P("data")),
                out_specs=(P(), P()),
                check_vma=False,
            )
        )(m.trainer.params, x, t, pdf)
        scale = np.abs(g_ref).max() + 1e-12
        np.testing.assert_allclose(
            np.asarray(g_dp) / scale, g_ref / scale, atol=2e-5,
            err_msg=otype,
        )
        np.testing.assert_allclose(
            float(loss_dp), float(loss_ref), rtol=1e-5, err_msg=otype
        )


def test_ema_adam_under_mesh_matches_single_device(devices):
    """A WRAPPED optimizer (EMA over Adam, ema.h:44-77
    custom_weights) under the data-parallel mesh. The wrapper's smoothed
    weights feed inference (trainer.h custom-weights plumbing), so both the
    training trajectory AND the EMA weight vector must match single-device
    execution."""
    cfg = dict(
        CFG,
        optimizer={
            "otype": "EMA",
            "decay": 0.95,
            "nested": {"otype": "Adam", "learning_rate": 1e-2},
        },
    )
    model_a = tc.create_from_config(2, 3, cfg)
    model_b = tc.create_from_config(2, 3, cfg)

    mesh = create_mesh(devices)
    dp = DataParallelTrainer(model_a.trainer, mesh)
    state_dp = dp.replicate(model_a.trainer.state)

    rng = np.random.default_rng(11)
    for i in range(8):
        x = jnp.asarray(rng.uniform(size=(1024, 2)), jnp.float32)
        t = _img(x)
        state_dp, loss_dp = dp.step(state_dp, x, t)
        loss_1 = model_b.trainer.training_step(x, t)
        np.testing.assert_allclose(
            float(loss_dp), float(loss_1), rtol=2e-3, err_msg=f"step {i}"
        )
    # the EMA custom weights (what inference uses) match across executions
    ema_dp = np.asarray(
        model_a.trainer.optimizer.custom_weights(
            state_dp["opt"], state_dp["params"]
        )
    )
    ema_1 = np.asarray(model_b.trainer.inference_params)
    scale = np.abs(ema_1).max() + 1e-12
    # bf16 forward/backward: the two executions reduce gradients in a
    # different order, so the step-0 ~3e-4 difference amplifies chaotically
    # through 8 Adam steps at lr 1e-2 (raw params drift to ~4e-3 normalized,
    # measured). The EMA must stay within that trajectory-divergence class
    # AND be no worse than the raw params it averages.
    p_dp = np.asarray(state_dp["params"])
    p_1 = np.asarray(model_b.trainer.state["params"])
    param_div = np.abs(p_dp - p_1).max() / scale
    ema_div = np.abs(ema_dp - ema_1).max() / scale
    assert ema_div < 5e-3, f"EMA weights diverged: {ema_div}"
    assert ema_div <= param_div * 1.5 + 1e-6, (ema_div, param_div)
