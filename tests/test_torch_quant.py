"""int8 post-training quantization: the port's ops/quant.py and K8's plain
version against the JAX package's ops/quant.py (CPU, FP32 policy, Pallas in
interpret mode on the JAX side).

Tolerances, with their reasons:
* weights: ``w_q`` bit-equal, ``w_s`` within 1 f32 ulp (amax / 127 may be
  a division on one side and a product with the reciprocal on the other);
* single int8 convs: the int32 accumulators exactly equal, the dequantized
  outputs within 1 f32 ulp (both convert the same integer and scale it);
* dynamic activation scale: equal;
* whole quantized models: 1e-3 relative RMS. Not max-abs: a 1e-6 difference
  upstream (f32 sums in another order) can move an activation across a
  round-half step of its quantizer, which moves that output by a full
  quantization step, so the largest single difference says little;
* calibrated static scales: each site within 1e-5 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_convlstm_tpu.core.dtypes import FP32_POLICY as JFP32
from unet_convlstm_tpu.models.resnet_unet import (
    ResNetUNetConfig as JResConfig, resnet_unet_apply as j_res_apply,
    resnet_unet_init)
from unet_convlstm_tpu.models.temporal_unet import (
    TemporalUNetConfig as JConfig, temporal_unet_apply as j_apply,
    temporal_unet_init)
from unet_convlstm_tpu.ops import quant as jq
from unet_convlstm_tpu_torch.core.dtypes import FP32_POLICY
from unet_convlstm_tpu_torch.models.resnet_unet import (
    PretrainedTemporalUNet, ResNetUNetConfig, resnet_unet_apply)
from unet_convlstm_tpu_torch.models.temporal_unet import (
    TemporalUNetConfig, TemporalUNetDualView, temporal_unet_apply)
from unet_convlstm_tpu_torch.ops import quant as tq
from unet_convlstm_tpu_torch.ops.kernels import conv_int8 as k8
from unet_convlstm_tpu_torch.ops.kernels import launch_counts
from unet_convlstm_tpu_torch.utils.torch_weights import state_dict_from_jax

CFG = dict(base_ch=4, use_skip_lstm=True, lstm_layers=1, use_attention=True)
B, T, HW = 1, 3, 32


def _ulps(a: np.ndarray, b: np.ndarray) -> int:
    a = np.ascontiguousarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.ascontiguousarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max()) if a.size else 0


def _rel_rms(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)) / np.sqrt(np.mean(b ** 2)))


@pytest.fixture(scope="module")
def custom():
    """A fresh JAX TemporalUNet (its dicts in init order), the port's model
    carrying the same weights, and both quantized."""
    v = temporal_unet_init(jax.random.PRNGKey(0), JConfig(**CFG))
    qv = jq.quantize_tree(v)
    m = TemporalUNetDualView(TemporalUNetConfig(**CFG))
    m.load_state_dict(state_dict_from_jax(jax.device_get(v)), strict=True)
    m.eval()
    return v, qv, m, tq.quantize_model(m)


@pytest.fixture(scope="module")
def frames():
    return np.random.default_rng(3).random((B, T, HW, HW, 2)).astype(
        np.float32)


def _j_custom(qv, x):
    y, _, _ = j_apply(qv, jnp.asarray(x), JConfig(**CFG), policy=JFP32,
                      use_pallas=True, use_fused_doubleconv=True)
    return np.asarray(y)


def _t_custom(qm, x):
    with torch.inference_mode():
        y, _, _ = temporal_unet_apply(qm, torch.from_numpy(x),
                                      policy=FP32_POLICY, use_pallas=True,
                                      use_fused_doubleconv=True)
    return y.numpy()


# ---------------------------------------------------------------------------
# weights and activations
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["conv", "transposed"])
def test_weight_quantization_matches_jax(kind):
    rng = np.random.default_rng(1)
    if kind == "conv":
        w = rng.standard_normal((3, 3, 20, 12)).astype(np.float32)   # HWIO
        w[..., 5] = 0.0                                   # scale 1 channel
        out_axis, t_w, t_axis = 3, np.transpose(w, (3, 2, 0, 1)), 0
    else:
        w = rng.standard_normal((2, 2, 12, 20)).astype(np.float32)   # HWOI
        w[:, :, 5] = 0.0
        out_axis, t_w, t_axis = 2, np.transpose(w, (3, 2, 0, 1)), 1
    jw, js = jq._quantize_weight(jnp.asarray(w), out_axis)
    tw, ts = tq.quantize_weight(torch.from_numpy(np.ascontiguousarray(t_w)),
                                t_axis)
    np.testing.assert_array_equal(tw.numpy(),
                                  np.transpose(np.asarray(jw), (3, 2, 0, 1)))
    assert _ulps(ts.numpy(), np.asarray(js)) <= 1
    assert ts[5].item() == 1.0 and not tw.select(t_axis, 5).any()


def test_dynamic_activation_scale_matches_jax():
    x = (np.random.default_rng(2).standard_normal((2, 5, 7, 6)) * 3).astype(
        np.float32)
    jx, js = jq._quantize_act(jnp.asarray(x))
    tx, ts = tq.quantize_act(torch.from_numpy(x))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    assert ts.item() == float(js)
    zx, zs = tq.quantize_act(torch.zeros(3, 4))           # amax 0: scale 1
    assert zs.item() == 1.0 and not zx.any()


CONVS = {  # name → (N, H, W, Cin, Cout, k, stride, JAX padding, port pads)
    "3x3_cin2": (2, 9, 11, 2, 8, 3, 1, "SAME", ((1, 1), (1, 1))),
    "3x3_cin20": (1, 7, 6, 20, 12, 3, 1, "SAME", ((1, 1), (1, 1))),
    "3x3_cin48": (1, 5, 5, 48, 16, 3, 1, "SAME", ((1, 1), (1, 1))),
    "1x1_s2": (2, 9, 7, 16, 24, 1, 2, "VALID", ((0, 0), (0, 0))),
    "7x7_s2": (1, 13, 11, 2, 8, 7, 2, [(3, 3), (3, 3)], ((3, 3), (3, 3))),
}


@pytest.mark.parametrize("name", sorted(CONVS))
def test_conv2d_int8_matches_jax(name):
    N, H, W, I, O, k, s, jpad, pads = CONVS[name]
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((N, H, W, I)) * 2).astype(np.float32)
    w = rng.standard_normal((k, k, I, O)).astype(np.float32)
    b = rng.standard_normal(O).astype(np.float32)
    jp = jq.quantize_conv_params({"w": jnp.asarray(w), "b": jnp.asarray(b)})
    y_j = np.asarray(jq.conv2d_int8(jp, jnp.asarray(x), s, jpad))
    m = tq.QuantConv2d(torch.from_numpy(np.transpose(np.asarray(jp["w_q"]),
                                                     (3, 2, 0, 1)).copy()),
                       torch.from_numpy(np.array(jp["w_s"])),
                       torch.from_numpy(b), site=0)
    y_t = tq.conv2d_int8(m, torch.from_numpy(x), s, pads).numpy()
    assert y_t.shape == y_j.shape
    assert _ulps(y_t, y_j) <= 1
    # the accumulators: exact integers on both sides
    x_q, _ = jq._quantize_act(jnp.asarray(x))
    acc_j = jax.lax.conv_general_dilated(
        x_q, jp["w_q"], (s, s), jpad, dimension_numbers=("NHWC", "HWIO",
                                                         "NHWC"),
        preferred_element_type=jnp.int32)
    acc_t = k8.int8_acc_plain(torch.from_numpy(np.asarray(x_q)), m.weight, s,
                              pads)
    np.testing.assert_array_equal(acc_t.numpy(), np.asarray(acc_j))
    assert launch_counts()["conv_int8"] == 0       # the CPU: plain version


def test_conv_transpose2d_int8_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 5, 7, 12)).astype(np.float32)
    wt = rng.standard_normal((2, 2, 6, 12)).astype(np.float32)   # HWOI
    b = rng.standard_normal(6).astype(np.float32)
    jp = jq.quantize_conv_params({"wt": jnp.asarray(wt), "b": jnp.asarray(b)})
    y_j = np.asarray(jq.conv_transpose2d_int8(jp, jnp.asarray(x), 2))
    m = tq.QuantConvTranspose2d(
        torch.from_numpy(np.transpose(np.asarray(jp["wt_q"]),
                                      (3, 2, 0, 1)).copy()),
        torch.from_numpy(np.asarray(jp["wt_s"])), torch.from_numpy(b), 0)
    y_t = tq.conv_transpose2d_int8(m, torch.from_numpy(x), 2).numpy()
    assert y_t.shape == y_j.shape == (2, 10, 14, 6)
    assert _ulps(y_t, y_j) <= 1
    # the accumulators: with unit scales and no bias the plain version
    # returns float(acc), exact here (|acc| <= 12 * 127^2 < 2^24)
    x_q, _ = jq._quantize_act(jnp.asarray(x))
    acc_j = jax.lax.conv_transpose(
        x_q, jp["wt_q"], (2, 2), "VALID",
        dimension_numbers=("NHWC", "HWIO", "NHWC"), transpose_kernel=True,
        preferred_element_type=jnp.int32)
    one = torch.ones((), dtype=torch.float32)
    acc_t = k8.conv_transpose_int8_plain(
        torch.from_numpy(np.asarray(x_q)), m.weight, torch.ones(6), one,
        None, 2, torch.float32)
    np.testing.assert_array_equal(acc_t.numpy(),
                                  np.asarray(acc_j).astype(np.float32))


def test_wrong_axis_scales_raise_as_in_jax():
    w = torch.zeros(4, 3, 3, 3, dtype=torch.int8)
    bad = tq.QuantConv2d(w, torch.ones(3), None, 0)        # 3 scales, O = 4
    with pytest.raises(ValueError, match="output channels"):
        tq.conv2d_int8(bad, torch.zeros(1, 4, 4, 3))
    bad_t = tq.QuantConvTranspose2d(torch.zeros(3, 4, 2, 2, dtype=torch.int8),
                                    torch.ones(3), None, 0)
    with pytest.raises(ValueError, match="output channels"):
        tq.conv_transpose2d_int8(bad_t, torch.zeros(1, 4, 4, 3))
    with pytest.raises(ValueError, match="output channels"):
        jq.conv2d_int8({"w_q": jnp.zeros((3, 3, 3, 4), jnp.int8),
                        "w_s": jnp.ones(3)}, jnp.zeros((1, 4, 4, 3)))


def test_act_calibration_refuses_to_nest():
    with tq.act_calibration():
        with pytest.raises(RuntimeError, match="do not nest"):
            with tq.act_calibration():
                pass
    with tq.act_calibration() as ranges:       # usable again after exit
        pass
    assert ranges == {}


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------

def test_sites_follow_the_jax_tree_walk(custom):
    """Each JAX SiteTag and the port's site of the same conv agree: the JAX
    walk numbers a fresh tree's convs in init order, the port in
    definition order. Tagged through the carry: every JAX w_s filled with
    its site id."""
    _, qv, _, qm = custom

    def walk(node):
        for key, sub in node.items():
            if isinstance(sub, dict) and "site" in sub:
                s = "w_s" if "w_s" in sub else "wt_s"
                sub[s] = np.full(sub[s].shape, sub["site"].sid, np.float32)
            elif isinstance(sub, dict):
                walk(sub)

    params = jax.device_get(qv["params"])
    walk(params)
    sd = state_dict_from_jax({"params": params,
                              "stats": jax.device_get(qv["stats"])})
    sites = {n: m.site for n, m in qm.named_modules()
             if isinstance(m, tq.QUANT_MODULES)}
    assert len(sites) == 27 and sorted(sites.values()) == list(range(27))
    for name, site in sites.items():
        assert set(sd[f"{name}.w_s"].tolist()) == {float(site)}, name


def test_carried_quantized_tree_equals_quantize_model(custom):
    _, qv, m, qm = custom
    sd = state_dict_from_jax(jax.device_get(qv))
    ours = qm.state_dict()
    assert set(sd) == set(ours)
    for k, v in sd.items():
        if v.dtype == torch.int8:
            assert torch.equal(v, ours[k]), k
        elif k.endswith(".w_s"):
            assert _ulps(v.numpy(), ours[k].numpy()) <= 1, k
        else:
            assert torch.equal(v, ours[k]), k
    assert all(p.is_floating_point() for p in m.parameters())   # untouched
    loaded = tq.quantize_model(m)
    tq.load_quantized_state_dict(loaded, sd)
    assert all(x.x_s is None for x in tq.quant_sites(loaded).values())


def test_quantized_custom_model_matches_jax(custom, frames):
    _, qv, _, qm = custom
    y_j = _j_custom(qv, frames)
    y_t = _t_custom(qm, frames)
    assert y_t.shape == y_j.shape == (B, T, HW, HW, 1)
    assert _rel_rms(y_t, y_j) < 1e-3


def test_calibrated_scales_match_jax_per_site(custom, frames):
    _, qv, _, qm = custom
    batches = [frames, frames[:, :2] * 0.5]

    def j_fn(v, x, train=False):
        return j_apply(v, x, JConfig(**CFG), train=train, policy=JFP32)

    cv = jq.calibrate_tree(j_fn, qv, batches)
    cm = tq.calibrate_tree(temporal_unet_apply, qm, batches,
                           policy=FP32_POLICY, use_pallas=True)
    assert all(x.x_s is None for x in tq.quant_sites(qm).values())
    theirs = state_dict_from_jax(jax.device_get(cv))
    ours = cm.state_dict()
    keys = [k for k in theirs if k.endswith(".x_s")]
    assert len(keys) == 27 and set(keys) == {k for k in ours
                                             if k.endswith(".x_s")}
    for k in keys:
        np.testing.assert_allclose(ours[k].numpy(), theirs[k].numpy(),
                                   rtol=1e-5, err_msg=k)
    # the calibrated models agree too, and a carried tree loads the scales
    assert _rel_rms(_t_custom(cm, frames), _j_custom(cv, frames)) < 1e-3
    loaded = tq.quantize_model(custom[2])
    tq.load_quantized_state_dict(loaded, theirs)
    assert all(x.x_s is not None for x in tq.quant_sites(loaded).values())


def test_quantized_resnet_model_matches_jax():
    """The ResNet18 family: the 7x7 stride-2 stem, stride-2 and 1x1
    downsample convs, the decoder and head, all int8."""
    v = jax.device_get(jax.jit(resnet_unet_init, static_argnums=1)(
        jax.random.PRNGKey(1), JResConfig(lstm_layers=1)))
    qv = jq.quantize_tree(v)
    m = PretrainedTemporalUNet(ResNetUNetConfig(lstm_layers=1))
    m.load_state_dict(state_dict_from_jax(v), strict=True)
    qm = tq.quantize_model(m.eval())
    sd = state_dict_from_jax(jax.device_get(qv))
    ours = qm.state_dict()
    assert {k for k in sd if k.endswith(".w_s")} == {
        k for k in ours if k.endswith(".w_s")}
    x = np.random.default_rng(6).random((1, 2, 32, 32, 2)).astype(np.float32)
    y_j, _, _ = j_res_apply(qv, jnp.asarray(x), JResConfig(lstm_layers=1),
                            policy=JFP32, use_pallas=True)
    with torch.inference_mode():
        y_t, _, _ = resnet_unet_apply(qm, torch.from_numpy(x),
                                      policy=FP32_POLICY, use_pallas=True)
    assert _rel_rms(y_t.numpy(), np.asarray(y_j)) < 1e-3


def test_ptq_noise_with_calibrated_batchnorm_matches_jax():
    """With BatchNorm running statistics set to a batch's (unit-scale
    activations through every conv, as a trained model has them) int8
    moves a random model far more than at init, and it moves the JAX
    model as far: the two packages' int8-against-f32 relative L2 agree
    within 10% of each other. (The card's checks bound the PTQ noise under
    the JAX test's condition, BatchNorm at init, and report it here.)"""
    cfg = dict(base_ch=8, use_skip_lstm=True, lstm_layers=1)
    v = jax.device_get(temporal_unet_init(jax.random.PRNGKey(2),
                                          JConfig(**cfg)))
    x = (np.random.default_rng(8).gamma(2.0, 0.6, (2, 2, 32, 32, 2))
         / 6).astype(np.float32)
    _, _, batch = j_apply(v, jnp.asarray(x), JConfig(**cfg), train=True,
                          policy=JFP32)

    def set_running(stats, new, momentum=0.1):
        for k, sub in new.items():
            if isinstance(sub, dict) and "mean" in sub:
                for s in ("mean", "var"):   # new = (1-m) old + m batch
                    stats[k][s] = ((np.asarray(sub[s]) - (1 - momentum)
                                    * np.asarray(stats[k][s])) / momentum)
            elif isinstance(sub, dict):
                set_running(stats[k], sub, momentum)

    set_running(v["stats"], jax.device_get(batch))
    y_f = np.asarray(j_apply(v, jnp.asarray(x), JConfig(**cfg),
                             policy=JFP32)[0])
    y_q = np.asarray(j_apply(jq.quantize_tree(v), jnp.asarray(x),
                             JConfig(**cfg), policy=JFP32)[0])
    m = TemporalUNetDualView(TemporalUNetConfig(**cfg))
    m.load_state_dict(state_dict_from_jax(v), strict=True)
    with torch.inference_mode():
        t_f = temporal_unet_apply(m.eval(), torch.from_numpy(x),
                                  policy=FP32_POLICY)[0].numpy()
        t_q = temporal_unet_apply(tq.quantize_model(m), torch.from_numpy(x),
                                  policy=FP32_POLICY)[0].numpy()
    assert _rel_rms(t_f, y_f) < 1e-4
    noise_j = np.linalg.norm(y_q - y_f) / np.linalg.norm(y_f)
    noise_t = np.linalg.norm(t_q - t_f) / np.linalg.norm(t_f)
    assert noise_j > 0 and abs(noise_t - noise_j) <= 0.1 * noise_j, (
        noise_t, noise_j)


# ---------------------------------------------------------------------------
# K8's quantizing entry (the quantizer in the kernel's prologue): its plain
# version, the CPU path, against the JAX int8 convs, bit for bit
# ---------------------------------------------------------------------------

XS = 2.0 ** -7   # a power of two: x / x_s is exact, so (k + 1/2) * x_s is
#                  a rounding midpoint, which rounds half to even


def _quant_x(rng, shape, static: bool, bf16: bool) -> np.ndarray:
    """x on the quantizer's edges: midpoints (k + 1/2) * XS, exact steps,
    values in between, and, with a static scale, beyond +-127 * XS (those
    clamp); with a dynamic scale one entry is max|x| = 127 * XS, which
    makes the dynamic scale XS too. In bf16 only values bf16 holds."""
    k = rng.integers(-150 if static else -127, 151 if static else 127, shape)
    frac = rng.choice([0.5, -0.5, 0.0, 0.25, 0.375], shape)
    x = np.clip((k + frac), -200, 200 if static else 126.5) * XS
    x = x.astype(np.float32)
    if not static:
        x.flat[0] = 127 * XS
    if bf16:
        x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    return x


def _port_x(x: np.ndarray, bf16: bool) -> torch.Tensor:
    t = torch.from_numpy(x)
    return t.to(torch.bfloat16) if bf16 else t


QUANT_CASES = [(name, static, bf16, out)
               for name in ("3x3_cin2", "3x3_cin48", "1x1_s2", "7x7_s2")
               for static in (True, False) for bf16 in (False, True)
               for out in ("f32", "bf16")]


@pytest.mark.parametrize("name,static,bf16,out", QUANT_CASES)
def test_quantizing_entry_plain_is_jax_conv2d_int8_bit_for_bit(
        name, static, bf16, out):
    N, H, W, I, O, k, s, jpad, pads = CONVS[name]
    rng = np.random.default_rng(11)
    x = _quant_x(rng, (N, H, W, I), static, bf16)
    w = rng.standard_normal((k, k, I, O)).astype(np.float32)
    b = rng.standard_normal(O).astype(np.float32)
    jp = jq.quantize_conv_params({"w": jnp.asarray(w), "b": jnp.asarray(b)})
    if static:
        jp["x_s"] = jnp.float32(XS)
    jdt, tdt = ((jnp.float32, torch.float32) if out == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    y_j = np.asarray(jq.conv2d_int8(jp, jnp.asarray(x), s, jpad,
                                    out_dtype=jdt).astype(jnp.float32))
    launches = launch_counts()["conv_int8"]
    y_t = k8.conv_int8_quant(
        _port_x(x, bf16),
        torch.from_numpy(np.transpose(np.asarray(jp["w_q"]),
                                      (3, 2, 0, 1)).copy()),
        torch.from_numpy(np.array(jp["w_s"])),
        torch.tensor(np.float32(XS)) if static else None,
        torch.from_numpy(b), s, pads, tdt)
    assert y_t.dtype == tdt and y_t.shape == y_j.shape
    np.testing.assert_array_equal(y_t.float().numpy().view(np.int32),
                                  y_j.view(np.int32))
    assert launch_counts()["conv_int8"] == launches     # the CPU: plain


@pytest.mark.parametrize("static,bf16", [(True, False), (False, False),
                                         (True, True), (False, True)])
def test_quantizing_entry_plain_is_jax_conv_transpose2d_int8_bit_for_bit(
        static, bf16):
    rng = np.random.default_rng(12)
    x = _quant_x(rng, (2, 5, 7, 16), static, bf16)
    wt = rng.standard_normal((2, 2, 8, 16)).astype(np.float32)   # HWOI
    b = rng.standard_normal(8).astype(np.float32)
    jp = jq.quantize_conv_params({"wt": jnp.asarray(wt),
                                  "b": jnp.asarray(b)})
    if static:
        jp["x_s"] = jnp.float32(XS)
    y_j = np.asarray(jq.conv_transpose2d_int8(jp, jnp.asarray(x), 2))
    y_t = k8.conv_transpose_int8_quant(
        _port_x(x, bf16),
        torch.from_numpy(np.transpose(np.asarray(jp["wt_q"]),
                                      (3, 2, 0, 1)).copy()),
        torch.from_numpy(np.asarray(jp["wt_s"])),
        torch.tensor(np.float32(XS)) if static else None,
        torch.from_numpy(b), 2, torch.float32)
    assert y_t.shape == y_j.shape == (2, 10, 14, 8)
    np.testing.assert_array_equal(y_t.numpy().view(np.int32),
                                  y_j.view(np.int32))


@pytest.mark.parametrize("static", [True, False])
def test_quantizer_rounds_midpoints_half_to_even_and_clamps(static):
    """The quantizer the kernel's prologue repeats, against JAX's: at
    midpoints, exact steps and beyond +-127 * x_s the int8 values are
    equal, and they are what round-half-to-even and the clamp give."""
    x = _quant_x(np.random.default_rng(13), (4, 6, 6, 16), static, False)
    if static:
        j_q = np.asarray(jnp.clip(jnp.round(jnp.asarray(x) / XS), -127,
                                  127).astype(jnp.int8))
        t_q, t_s = k8.quantize_with(torch.from_numpy(x),
                                    torch.tensor(np.float32(XS))), XS
    else:
        j_q, j_s = jq._quantize_act(jnp.asarray(x))
        j_q = np.asarray(j_q)
        t_q, t_s = k8.quantize_act(torch.from_numpy(x))
        assert float(j_s) == t_s.item() == XS
    np.testing.assert_array_equal(t_q.numpy(), j_q)
    r = x.astype(np.float64) / XS
    np.testing.assert_array_equal(t_q.numpy(),
                                  np.clip(np.rint(r), -127, 127))  # rint: even
    mid = np.abs(r - np.floor(r) - 0.5) == 0
    assert mid.sum() > 100 and (np.abs(r) > 127).any() == static
