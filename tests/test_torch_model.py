"""The port's TemporalUNetDualView against the JAX package's, through the
weight-carry function: FP32 policy, both kernel flags on (Pallas in
interpret mode on the JAX side, the kernels' plain versions on the port's).

base_ch 16 because the JAX routing fuses a DoubleConv only when
min(c1, c2) >= 16; at 32x32 the bottleneck is then C = 256 (and skip3
C = 128), so the JAX gate kernel engages too."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_convlstm_tpu.core.dtypes import FP32_POLICY as JFP32
from unet_convlstm_tpu.models.temporal_unet import (
    TemporalUNetConfig as JConfig, temporal_unet_apply as j_apply,
    temporal_unet_init)
from unet_convlstm_tpu.utils.torch_weights import (
    export_temporal_unet_checkpoint)
from unet_convlstm_tpu_torch.core.dtypes import FP32_POLICY
from unet_convlstm_tpu_torch.models.registry import build_model
from unet_convlstm_tpu_torch.models.temporal_unet import (
    TemporalUNetConfig, TemporalUNetDualView, temporal_unet_apply,
    temporal_unet_init_state)
from unet_convlstm_tpu_torch.utils.torch_weights import state_dict_from_jax

CFG = dict(base_ch=16, use_skip_lstm=True, lstm_layers=1)


def jax_variables(cfg: dict, seed: int = 0):
    """A JAX model with random weights and non-trivial BatchNorm affine
    parameters and running statistics (numpy leaves)."""
    v = jax.device_get(temporal_unet_init(jax.random.PRNGKey(seed),
                                          JConfig(**cfg)))
    rng = np.random.default_rng(seed)

    def perturb(tree):
        for k, sub in tree.items():
            if isinstance(sub, dict) and {"scale", "bias"} <= set(sub):
                n = sub["scale"].shape[0]
                sub["scale"] = (rng.random(n) + 0.5).astype(np.float32)
                sub["bias"] = (rng.standard_normal(n) * 0.2).astype(np.float32)
            elif isinstance(sub, dict) and {"mean", "var"} <= set(sub):
                n = sub["mean"].shape[0]
                sub["mean"] = (rng.standard_normal(n) * 0.1).astype(np.float32)
                sub["var"] = (rng.random(n) * 0.5 + 0.2).astype(np.float32)
            elif isinstance(sub, dict):
                perturb(sub)

    perturb(v["params"])
    perturb(v["stats"])
    return v


@pytest.fixture(scope="module")
def variables():
    return jax_variables(CFG)


def test_weight_carry_matches_jax_export_and_loads_strict(variables):
    ours = state_dict_from_jax(variables)
    theirs = export_temporal_unet_checkpoint(variables)
    assert set(ours) == set(theirs)
    for k, v in theirs.items():
        np.testing.assert_array_equal(ours[k].numpy(), v)
    model = TemporalUNetDualView(TemporalUNetConfig(**CFG))
    model.load_state_dict(ours, strict=True)
    assert set(model.state_dict()) == set(ours)


def test_apply_matches_jax_with_kernels_on(variables):
    rng = np.random.default_rng(7)
    B, T, H, W = 1, 2, 32, 32
    x = rng.random((B, T, H, W, 2)).astype(np.float32)
    y_j, s_j, _ = j_apply(variables, jnp.asarray(x), JConfig(**CFG),
                          policy=JFP32, use_pallas=True,
                          use_fused_doubleconv=True)
    model = TemporalUNetDualView(TemporalUNetConfig(**CFG))
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    with torch.inference_mode():
        y_t, s_t, _ = temporal_unet_apply(
            model, torch.from_numpy(x), policy=FP32_POLICY, use_pallas=True,
            use_fused_doubleconv=True)
    assert y_t.shape == (B, T, H, W, 1)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j),
                               rtol=1e-3, atol=1e-3)
    assert set(s_t) == set(s_j) == {"temporal", "skip3", "skip2"}
    for k in s_t:
        for (ht, ct), (hj, cj) in zip(s_t[k], s_j[k]):
            np.testing.assert_allclose(ht.numpy(), np.asarray(hj),
                                       rtol=1e-3, atol=1e-3)
            np.testing.assert_allclose(ct.numpy(), np.asarray(cj),
                                       rtol=1e-3, atol=1e-3)


def test_streaming_state_and_registry():
    cfg, init, apply, init_state = build_model({"base_ch": 8})
    assert cfg.base_ch == 8 and cfg.use_skip_lstm     # registry defaults
    model = init(torch.Generator().manual_seed(0), device="cpu")
    x = torch.rand(1, 3, 32, 32, 2)
    state = init_state(1, 32, 32)
    assert [t.shape for t in state["skip2"][0]] == [(1, 8, 8, 32)] * 2
    with torch.inference_mode():
        y_all, _, _ = apply(model, x, policy=FP32_POLICY, use_pallas=True,
                            use_fused_doubleconv=True)
        parts = []
        for t in range(3):
            y, state, _ = apply(model, x[:, t:t + 1], state=state,
                                policy=FP32_POLICY, use_pallas=True,
                                use_fused_doubleconv=True)
            parts.append(y)
    np.testing.assert_allclose(torch.cat(parts, 1).numpy(), y_all.numpy(),
                               rtol=1e-5, atol=1e-5)
    rcfg, *_ = build_model({"type": "resnet18", "freeze_encoder": False})
    assert type(rcfg).__name__ == "ResNetUNetConfig"  # the second family
    with pytest.raises(ValueError, match="unknown model type"):
        build_model({"type": "vit"})
    zero = temporal_unet_init_state(TemporalUNetConfig(base_ch=4), 2, 32, 32)
    assert set(zero) == {"temporal"}
