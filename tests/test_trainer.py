"""Trainer / config end-to-end tests: convergence, checkpointing, external
gradients, module API."""

import jax
import jax.numpy as jnp
import numpy as np

import tcnn_tpu as tc

CONFIG = {
    "loss": {"otype": "RelativeL2"},
    "optimizer": {"otype": "Adam", "learning_rate": 1e-2, "beta1": 0.9,
                  "beta2": 0.99, "epsilon": 1e-15, "l2_reg": 1e-6},
    "encoding": {"otype": "HashGrid", "n_levels": 8, "n_features_per_level": 2,
                 "log2_hashmap_size": 13, "base_resolution": 4,
                 "per_level_scale": 1.5},
    "network": {"otype": "FullyFusedMLP", "activation": "ReLU",
                "output_activation": "None", "n_neurons": 64,
                "n_hidden_layers": 2},
}


def _target(x):
    return jnp.stack(
        [jnp.sin(4 * x[:, 0]), jnp.cos(3 * x[:, 1]), x[:, 0] * x[:, 1]], -1
    )


def test_training_converges():
    m = tc.create_from_config(2, 3, CONFIG)
    x = jax.random.uniform(jax.random.PRNGKey(0), (512, 2))
    t = _target(x)
    first = float(m.trainer.training_step(x, t))
    for _ in range(150):
        lv = m.trainer.training_step(x, t)
    final = float(lv)
    assert final < first * 1e-2, (first, final)
    out = m.trainer.inference(x)
    assert out.shape == (512, 3)
    assert float(jnp.mean((out - t) ** 2)) < 1e-2


def test_param_layout_network_first():
    # network_with_input_encoding.h:115-130
    m = tc.create_from_config(2, 3, CONFIG)
    net = m.network
    assert net.n_params == net.network.n_params + net.encoding.n_params
    net_p, enc_p = net.split_params(m.trainer.params)
    assert net_p.shape[0] == net.network.n_params


def test_serialize_roundtrip(tmp_path):
    m = tc.create_from_config(2, 3, CONFIG)
    x = jax.random.uniform(jax.random.PRNGKey(1), (256, 2))
    t = _target(x)
    for _ in range(10):
        m.trainer.training_step(x, t)
    snap = m.trainer.serialize()

    m2 = tc.create_from_config(2, 3, CONFIG, seed=999)
    m2.trainer.deserialize(snap)
    np.testing.assert_allclose(
        np.asarray(m2.trainer.params), np.asarray(m.trainer.params)
    )
    # optimizer moments restored: next steps must agree exactly
    l1 = float(m.trainer.training_step(x, t))
    l2 = float(m2.trainer.training_step(x, t))
    np.testing.assert_allclose(l1, l2, rtol=1e-6)


def test_external_dl_doutput():
    m = tc.create_from_config(2, 3, CONFIG)
    x = jax.random.uniform(jax.random.PRNGKey(2), (128, 2))
    dl = jnp.ones((128, m.network.padded_output_width), jnp.float32)
    p0 = np.asarray(m.trainer.params)
    m.trainer.training_step(x, dL_doutput=dl)
    assert not np.allclose(p0, np.asarray(m.trainer.params))


def test_data_pdf():
    m = tc.create_from_config(2, 3, CONFIG)
    x = jax.random.uniform(jax.random.PRNGKey(3), (128, 2))
    t = _target(x)
    pdf = jnp.full((128, 3), 2.0)
    l_pdf = float(m.trainer.training_step(x, t, pdf=pdf))
    m2 = tc.create_from_config(2, 3, CONFIG)
    l_plain = float(m2.trainer.training_step(x, t))
    np.testing.assert_allclose(l_pdf, l_plain / 2.0, rtol=1e-3)


def test_update_hyperparams_lr():
    m = tc.create_from_config(2, 3, CONFIG)
    m.trainer.update_hyperparams({"optimizer": {"learning_rate": 5e-4}})
    assert m.optimizer.learning_rate == 5e-4


def test_module_api_batch_padding():
    mod = tc.NetworkWithInputEncoding(2, 3, CONFIG["encoding"], CONFIG["network"])
    x = jax.random.uniform(jax.random.PRNGKey(4), (100, 2))  # not a multiple of 128
    y = mod(x)
    assert y.shape == (100, 3)
    assert y.dtype == jnp.float32


def test_module_gradients_both_ways():
    mod = tc.NetworkWithInputEncoding(2, 3, CONFIG["encoding"], CONFIG["network"])
    x = jax.random.uniform(jax.random.PRNGKey(5), (128, 2))

    def f(params, x):
        return jnp.sum(mod(x, params) ** 2)

    gp, gx = jax.grad(f, argnums=(0, 1))(mod.params, x)
    assert gp.shape == mod.params.shape
    assert gx.shape == x.shape
    assert float(jnp.abs(gx).sum()) > 0


def test_network_module_routes_through_identity():
    # cpp_api.cu:151-153: Network == Identity encoding + network
    mod = tc.Network(3, 2, {"otype": "CutlassMLP", "n_neurons": 16,
                            "n_hidden_layers": 1})
    # identity pads 3 -> 16 with ones; input weight matrix is [16, 16]
    assert mod.model.network.input_width == 16
    y = mod(jnp.zeros((4, 3)))
    assert y.shape == (4, 2)


def test_encoding_module():
    mod = tc.Encoding(3, {"otype": "HashGrid", "n_levels": 4,
                          "base_resolution": 4, "log2_hashmap_size": 10})
    assert mod.n_output_dims == 8
    y = mod(jax.random.uniform(jax.random.PRNGKey(6), (64, 3)))
    assert y.shape == (64, 8)
    assert mod.n_params > 0


def test_loss_swap_via_update_hyperparams():
    m = tc.create_from_config(2, 3, CONFIG)
    m.trainer.update_hyperparams({"loss": {"otype": "L2"}})
    assert m.trainer.loss_fn.otype == "L2"


def test_ema_inference_params():
    cfg = dict(CONFIG)
    cfg["optimizer"] = {"otype": "EMA", "decay": 0.9,
                        "nested": CONFIG["optimizer"]}
    m = tc.create_from_config(2, 3, cfg)
    x = jax.random.uniform(jax.random.PRNGKey(7), (128, 2))
    t = _target(x)
    for _ in range(5):
        m.trainer.training_step(x, t)
    ip = np.asarray(m.trainer.inference_params)
    lp = np.asarray(m.trainer.params)
    assert ip.shape == lp.shape
    assert not np.allclose(ip, lp)


def test_orbax_checkpoint_roundtrip(tmp_path):
    import shutil

    cfg = {
        "loss": {"otype": "L2"},
        "optimizer": {"otype": "Adam"},
        "encoding": {"otype": "Identity"},
        "network": {"otype": "CutlassMLP", "n_neurons": 16, "n_hidden_layers": 1},
    }
    m = tc.create_from_config(2, 1, cfg)
    x = jnp.ones((128, 2)) * 0.3
    t = jnp.ones((128, 1)) * 0.7
    for _ in range(3):
        m.trainer.training_step(x, t)
    path = str(tmp_path / "ckpt")
    m.trainer.save_orbax(path)
    m2 = tc.create_from_config(2, 1, cfg)
    m2.trainer.load_orbax(path)
    np.testing.assert_array_equal(
        np.asarray(m.trainer.state["params"]), np.asarray(m2.trainer.state["params"])
    )


def test_max_level_schedule_takes_effect_without_invalidate():
    """max_level is baked in at trace time; the jit cache
    key must include it so a coarse-to-fine schedule (mutating
    encoding.max_level between steps via update_hyperparams) actually
    changes the compiled step - the reference treats max_level as a
    per-launch runtime value (grid.h:236-240)."""
    m = tc.create_from_config(2, 3, CONFIG)
    x = jax.random.uniform(jax.random.PRNGKey(0), (256, 2))

    m.network.encoding.update_hyperparams({"max_level": 0.25})
    out_coarse = np.asarray(m.trainer.forward(x)["output"], np.float32)
    m.network.encoding.update_hyperparams({"max_level": 1.0})
    out_full = np.asarray(m.trainer.forward(x)["output"], np.float32)
    assert not np.allclose(out_coarse, out_full), (
        "max_level change must re-trace the cached step"
    )


def test_reference_format_half_snapshot_roundtrip():
    """trainer.h:290-315 parity: deserialize accepts a reference-style
    snapshot with params_type "__half" and the raw byte-list binary layout
    nlohmann produces in text JSON (gpu_memory_json.h:37-72)."""
    m = tc.create_from_config(2, 3, CONFIG)
    params = np.asarray(m.trainer.params)
    half = params.astype(np.float16)

    snapshot = {
        "n_params": int(params.size),
        "params_type": "__half",
        "params_binary": list(half.tobytes()),  # nlohmann byte array
    }
    m2 = tc.create_from_config(2, 3, CONFIG)
    m2.trainer.deserialize(snapshot)
    np.testing.assert_array_equal(
        np.asarray(m2.trainer.params), half.astype(np.float32)
    )

    # float-typed byte-list snapshot too
    snap_f = {
        "params_type": "float",
        "params_binary": list(params.tobytes()),
    }
    m2.trainer.deserialize(snap_f)
    np.testing.assert_array_equal(np.asarray(m2.trainer.params), params)

    import pytest

    with pytest.raises(ValueError, match="float or __half"):
        m2.trainer.deserialize({"params_type": "double", "params_binary": []})
