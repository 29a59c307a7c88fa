"""The port's ResNet18-UNet (PretrainedTemporalUNet) against the JAX
package's, through the weight-carry function: FP32 policy, the gate-update
kernel flag on (Pallas in interpret mode on the JAX side at C = 128, 256
and 512, its XLA chain at C = 64; the kernel's plain version on the
port's).

B=1, T=2, 32x32 (the smallest side 32 divides: the bottleneck is 1x1),
lstm_layers 1 and 2. Tolerances: 1e-5 for the encoder's features and for
every BatchNorm stat (per-op), 1e-3 for the full model's output and state.

Where the encoder's BatchNorm runs on batch statistics (train unfrozen,
``encoder_bn_train``), 32x32 leaves layer4 two values per channel: its
variance, E[x^2] - E[x]^2 in f32, is then as small as the summation-order
noise of the layers before, and both sides' features at /32 part by 5% of
their range. Those modes run at 64x64 (8 values per channel at /32), and
the train-mode pyramid is held to 1e-4 of each feature's max |f|: 20
train-mode BatchNorms, each dividing by a batch std summed in another
order (3.6e-5 measured at /32 on these inputs, 1e-6 to 1e-5 above it).
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_convlstm_tpu.core.dtypes import FP32_POLICY as JFP32
from unet_convlstm_tpu.models.resnet_unet import (
    ResNetUNetConfig as JConfig, resnet18_encoder_apply as j_encoder,
    resnet_unet_apply as j_apply, resnet_unet_init)
from unet_convlstm_tpu.utils.torch_weights import (
    export_pretrained_temporal_unet_checkpoint)
from unet_convlstm_tpu_torch.core.dtypes import FP32_POLICY
from unet_convlstm_tpu_torch.models.registry import build_model
from unet_convlstm_tpu_torch.models.resnet_unet import (
    PretrainedTemporalUNet, ResNetUNetConfig, resnet18_encoder_apply,
    resnet_unet_apply, resnet_unet_init_state)
from unet_convlstm_tpu_torch.utils.torch_weights import state_dict_from_jax

B, T, HW = 1, 2, 32
HW_BN = 64          # where the encoder's BatchNorm uses batch statistics
MODES = {  # mode → (config flags, train, side)
    "eval": (dict(freeze_encoder=True), False, HW),
    "train_frozen": (dict(freeze_encoder=True), True, HW),
    "train_unfrozen": (dict(freeze_encoder=False), True, HW_BN),
    "encoder_bn_train": (dict(freeze_encoder=True, encoder_bn_train=True),
                         True, HW_BN),
}


def perturb_bn(v, seed: int = 0):
    """Non-trivial BatchNorm affine parameters and running stats, in place
    (numpy leaves)."""
    rng = np.random.default_rng(seed)

    def walk(tree):
        for sub in tree.values():
            if isinstance(sub, dict) and {"scale", "bias"} <= set(sub):
                n = sub["scale"].shape[0]
                sub["scale"] = (rng.random(n) + 0.5).astype(np.float32)
                sub["bias"] = (rng.standard_normal(n) * 0.2).astype(
                    np.float32)
            elif isinstance(sub, dict) and {"mean", "var"} <= set(sub):
                n = sub["mean"].shape[0]
                sub["mean"] = (rng.standard_normal(n) * 0.1).astype(
                    np.float32)
                sub["var"] = (rng.random(n) * 0.5 + 0.2).astype(np.float32)
            elif isinstance(sub, dict):
                walk(sub)

    walk(v["params"])
    walk(v["stats"])
    return v


def jax_variables(lstm_layers: int, seed: int = 0):
    init = jax.jit(resnet_unet_init, static_argnums=1)
    v = jax.device_get(init(jax.random.PRNGKey(seed),
                            JConfig(lstm_layers=lstm_layers)))
    return perturb_bn(v, seed)


def port_model(v, **flags) -> PretrainedTemporalUNet:
    lstm_layers = len(v["params"]["temporal"])
    model = PretrainedTemporalUNet(ResNetUNetConfig(lstm_layers=lstm_layers,
                                                    **flags))
    model.load_state_dict(state_dict_from_jax(v), strict=True)
    return model


def assert_bn_stats_match(model, stats_t, stats_j, atol=1e-5):
    """Every BatchNorm's new (mean, var) in the port's stats tree against
    the JAX tree's {"mean", "var"} at the same path (the paths under the
    tree's top-level keys)."""
    paths = [p for p in model.bn_layers() if p[0] in stats_t]
    assert paths
    for path in paths:
        t, j = stats_t, stats_j
        for key in path:
            t, j = t[key], j[key]
        for ours, theirs in zip(t, (j["mean"], j["var"])):
            np.testing.assert_allclose(ours.detach().numpy(),
                                       np.asarray(theirs), rtol=atol,
                                       atol=atol, err_msg=str(path))


@pytest.fixture(scope="module", params=[1, 2], ids=["L1", "L2"])
def variables(request):
    return jax_variables(request.param)


def make_frames(side: int = HW):
    return np.random.default_rng(7).random((B, T, side, side, 2)).astype(
        np.float32)


@pytest.fixture(scope="module")
def frames():
    return make_frames()


def test_weight_carry_matches_jax_export_and_loads_strict(variables):
    ours = state_dict_from_jax(variables)
    theirs = export_pretrained_temporal_unet_checkpoint(variables)
    dead = {k for k in theirs if k.startswith("lstm_skips.0.")}
    assert dead and all(not theirs[k].any() for k in dead)
    assert set(ours) == set(theirs) - dead
    for k, v in ours.items():
        np.testing.assert_array_equal(v.numpy(), theirs[k], err_msg=k)
    model = port_model(variables)
    assert set(model.state_dict()) == set(ours)
    # a reference state dict (with lstm_skips.0) loads: only those keys
    # are dropped, any other extra key still fails the strict load
    ref = {k: torch.from_numpy(np.array(a)) for k, a in theirs.items()}
    model.load_state_dict(ref, strict=True)
    with pytest.raises(RuntimeError, match="Unexpected key"):
        model.load_state_dict(dict(ref, **{"lstm_skips.5.x": ref[
            "segmentation_head.0.bias"]}), strict=True)
    n = len(variables["params"]["temporal"])
    assert len(model.lstm.layers) == n and sorted(model.lstm_skips) == [
        "1", "2", "3", "4"]


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_encoder_pyramid_matches_jax(variables, train):
    side = HW_BN if train else HW
    x = make_frames(side).reshape(B * T, side, side, 2)
    f_j, s_j = j_encoder(variables["params"]["encoder"],
                         variables["stats"]["encoder"], jnp.asarray(x),
                         train, JFP32)
    model = port_model(variables)
    with torch.inference_mode():
        f_t, s_t = resnet18_encoder_apply(model.encoder, torch.from_numpy(x),
                                          train, FP32_POLICY)
    assert [tuple(f.shape) for f in f_t] == [
        (B * T, side // d, side // d, c)
        for d, c in zip((2, 4, 8, 16, 32), (64, 64, 128, 256, 512))]
    for ft, fj in zip(f_t, f_j):
        fj = np.asarray(fj)
        atol = 1e-4 * np.abs(fj).max() if train else 1e-5
        np.testing.assert_allclose(ft.numpy(), fj, rtol=1e-5, atol=atol)
    assert_bn_stats_match(model, {"encoder": s_t}, {"encoder": s_j})


@pytest.mark.parametrize("mode", list(MODES))
def test_apply_matches_jax(variables, mode):
    flags, train, side = MODES[mode]
    frames = make_frames(side)
    y_j, st_j, ns_j = j_apply(variables, jnp.asarray(frames),
                              JConfig(lstm_layers=len(
                                  variables["params"]["temporal"]), **flags),
                              train=train, policy=JFP32, use_pallas=True)
    model = port_model(variables, **flags)
    with torch.inference_mode():
        y_t, st_t, ns_t = resnet_unet_apply(model, torch.from_numpy(frames),
                                            train=train, policy=FP32_POLICY,
                                            use_pallas=True)
    assert y_t.shape == (B, T, side, side, 1)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=1e-3,
                               atol=1e-3)
    assert set(st_t) == set(st_j) == {"temporal", "skip0", "skip1",
                                      "skip2", "skip3"}
    for k in st_t:
        assert len(st_t[k]) == len(st_j[k])
        for (ht, ct), (hj, cj) in zip(st_t[k], st_j[k]):
            np.testing.assert_allclose(ht.numpy(), np.asarray(hj),
                                       rtol=1e-3, atol=1e-3)
            np.testing.assert_allclose(ct.numpy(), np.asarray(cj),
                                       rtol=1e-3, atol=1e-3)
    assert_bn_stats_match(model, ns_t, ns_j)
    frozen = flags["freeze_encoder"] and not flags.get("encoder_bn_train")
    if frozen:   # the returned encoder stats are the running buffers
        assert ns_t["encoder"]["bn1"][0] is model.encoder.bn1.running_mean


def test_streaming_two_calls_equal_one(frames):
    """Carrying (h, c) frame by frame equals the whole-sequence pass."""
    _, init, apply, init_state = build_model(
        {"type": "resnet18", "lstm_layers": 2, "freeze_encoder": False})
    model = init(torch.Generator().manual_seed(0), device="cpu")
    x = torch.from_numpy(frames)
    state = init_state(B, HW, HW)
    assert [tuple(t.shape) for t in state["skip0"][1]] == [(1, 16, 16, 64)] * 2
    assert [tuple(t.shape) for t in state["temporal"][0]] == [(1, 1, 1,
                                                               512)] * 2
    kw = dict(policy=FP32_POLICY, use_pallas=True, use_fused_doubleconv=True)
    with torch.inference_mode():
        y_all, s_all, _ = apply(model, x, **kw)
        parts = []
        for t in range(T):
            y, state, _ = apply(model, x[:, t:t + 1], state=state, **kw)
            parts.append(y)
    np.testing.assert_allclose(torch.cat(parts, 1).numpy(), y_all.numpy(),
                               rtol=1e-5, atol=1e-5)
    for k in s_all:
        for (ha, ca), (hs, cs) in zip(s_all[k], state[k]):
            np.testing.assert_allclose(hs.numpy(), ha.numpy(), rtol=1e-5,
                                       atol=1e-5)
            np.testing.assert_allclose(cs.numpy(), ca.numpy(), rtol=1e-5,
                                       atol=1e-5)
    zero = resnet_unet_init_state(ResNetUNetConfig(lstm_layers=1), 2, 64, 64)
    assert [len(v) for v in zero.values()] == [1] * 5
    assert tuple(zero["skip3"][0][0].shape) == (2, 4, 4, 256)


def test_registry_builds_the_family(monkeypatch, tmp_path):
    """With no weights anywhere, freeze_encoder falls back to False with a
    warning, written back into the caller's dict; pretrained_resolved keeps
    the saved decision and loads nothing."""
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.delenv("TORCH_HOME", raising=False)
    monkeypatch.chdir(tmp_path)
    d = {"type": "resnet18", "lstm_layers": 1}
    with pytest.warns(UserWarning, match="falling back to freeze_encoder"):
        cfg, *_ = build_model(d)
    assert d["freeze_encoder"] is False and cfg.freeze_encoder is False
    assert (cfg.lstm_layers, cfg.in_channels, cfg.out_channels) == (1, 2, 1)
    saved = {"type": "resnet18", "freeze_encoder": True,
             "pretrained_resolved": True, "lstm_layers": 2}
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        cfg, init, _, _ = build_model(saved)
    assert saved["freeze_encoder"] is True and cfg.freeze_encoder
    model = init(torch.Generator().manual_seed(0))
    assert len(model.lstm_skips["1"].layers) == 2
