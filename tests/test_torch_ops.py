"""Per-op parity of the PyTorch port (unet_convlstm_tpu_torch/ops) with the
JAX package: the same numpy inputs through both, FP32 policy, at 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_convlstm_tpu.core.dtypes import FP32_POLICY as JFP32
from unet_convlstm_tpu.models import layout as jlayout
from unet_convlstm_tpu.ops import conv as jconv
from unet_convlstm_tpu.ops import normalize as jnorm
from unet_convlstm_tpu_torch.core.dtypes import FP32_POLICY
from unet_convlstm_tpu_torch.models import layout as tlayout
from unet_convlstm_tpu_torch.ops import conv as tconv
from unet_convlstm_tpu_torch.ops import normalize as tnorm

TOL = dict(rtol=1e-5, atol=1e-5)


def _oihw(w_hwio):
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(w_hwio, (3, 2, 0, 1))))


@pytest.mark.parametrize("k,stride,padding", [
    (3, 1, "SAME"), (3, 2, "SAME"), (1, 1, "SAME"), (3, 1, "VALID"),
    (3, 1, [(1, 2), (0, 1)]), (7, 1, "SAME"),
])
def test_conv2d(k, stride, padding):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, 10, 5)).astype(np.float32)
    w = rng.standard_normal((k, k, 5, 6)).astype(np.float32) * 0.2
    b = rng.standard_normal(6).astype(np.float32)
    yj = jconv.conv2d({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                      jnp.asarray(x), stride=stride, padding=padding,
                      policy=JFP32)
    yt = tconv.conv2d(torch.from_numpy(x), _oihw(w), torch.from_numpy(b),
                      stride=stride, padding=padding, policy=FP32_POLICY)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)


def test_conv_transpose2d():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 6, 8)).astype(np.float32)
    wt = rng.standard_normal((2, 2, 4, 8)).astype(np.float32) * 0.3  # HWOI
    b = rng.standard_normal(4).astype(np.float32)
    yj = jconv.conv_transpose2d({"wt": jnp.asarray(wt), "b": jnp.asarray(b)},
                                jnp.asarray(x), policy=JFP32)
    # the torch weight is wt.transpose(3, 2, 0, 1): (in, out, kh, kw)
    yt = tconv.conv_transpose2d(torch.from_numpy(x), _oihw(wt),
                                torch.from_numpy(b), policy=FP32_POLICY)
    assert yt.shape == (2, 10, 12, 4)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)


def test_max_pool2d():
    x = np.random.default_rng(2).standard_normal((2, 8, 6, 3)).astype(
        np.float32)
    np.testing.assert_array_equal(
        tconv.max_pool2d(torch.from_numpy(x), 2).numpy(),
        np.asarray(jconv.max_pool2d(jnp.asarray(x), 2)))


def _bn_pair(rng, c):
    scale = (rng.random(c) + 0.5).astype(np.float32)
    bias = rng.standard_normal(c).astype(np.float32) * 0.3
    mean = rng.standard_normal(c).astype(np.float32) * 0.2
    var = (rng.random(c) + 0.5).astype(np.float32)
    bn = torch.nn.BatchNorm2d(c)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.running_mean.copy_(torch.from_numpy(mean))
        bn.running_var.copy_(torch.from_numpy(var))
    params = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    stats = {"mean": jnp.asarray(mean), "var": jnp.asarray(var)}
    return bn, params, stats


@pytest.mark.parametrize("train", [False, True])
def test_batchnorm(train):
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((3, 5, 4, 6)) * 2 + 1).astype(np.float32)
    bn, params, stats = _bn_pair(rng, 6)
    yj, sj = jconv.batchnorm(params, stats, jnp.asarray(x), train)
    with torch.no_grad():
        yt, (mean, var) = tconv.batchnorm(bn, torch.from_numpy(x), train)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)
    np.testing.assert_allclose(mean.numpy(), np.asarray(sj["mean"]), **TOL)
    np.testing.assert_allclose(var.numpy(), np.asarray(sj["var"]), **TOL)


@pytest.mark.parametrize("train", [False, True])
def test_batchnorm_from_sums(train):
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((3, 5, 4, 6)) * 2 + 1).astype(np.float32)
    bn, params, stats = _bn_pair(rng, 6)
    s, q = x.sum((0, 1, 2)), (x * x).sum((0, 1, 2))
    ij, hj, sj = jconv.batchnorm_from_sums(params, stats, jnp.asarray(s),
                                           jnp.asarray(q), 60, train)
    with torch.no_grad():
        it, ht, (mean, var) = tconv.batchnorm_from_sums(
            bn, torch.from_numpy(s), torch.from_numpy(q), 60, train)
    for a, b in ((it, ij), (ht, hj), (mean, sj["mean"]), (var, sj["var"])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_time_major_flatten():
    x = np.arange(2 * 3 * 2 * 2 * 1, dtype=np.float32).reshape(2, 3, 2, 2, 1)
    flat_t = tlayout.flatten_seq(torch.from_numpy(x))
    flat_j = jlayout.flatten_seq(jnp.asarray(x), "time")
    np.testing.assert_array_equal(flat_t.numpy(), np.asarray(flat_j))
    tm_t = tlayout.to_time_major(flat_t, 2, 3)
    np.testing.assert_array_equal(
        tm_t.numpy(), np.asarray(jlayout.to_time_major(flat_j, 2, 3, "time")))
    np.testing.assert_array_equal(
        tlayout.to_batch_major(tm_t, 2, 3).numpy(), flat_t.numpy())
    np.testing.assert_array_equal(
        tlayout.unflatten_seq(flat_t, 2, 3).numpy(), x)


@pytest.mark.parametrize("transform", ["asinh", "signed_log", "none"])
def test_norm_stats_and_transforms(transform):
    rng = np.random.default_rng(5)
    X = rng.random((4, 3, 8, 8, 2)).astype(np.float32) * 3
    Y = (rng.standard_normal((4, 3, 8, 8, 1)) * 5).astype(np.float32)
    st = tnorm.compute_norm_stats(X, Y, y_transform=transform)
    sj = jnorm.compute_norm_stats(X, Y, y_transform=transform)
    assert st.to_dict() == sj.to_dict()
    np.testing.assert_allclose(
        tnorm.normalize_x(torch.from_numpy(X), st).numpy(),
        np.asarray(jnorm.normalize_x(jnp.asarray(X), sj)), **TOL)
    yn = np.clip(Y / 10, -1, 1).astype(np.float32)
    np.testing.assert_allclose(
        tnorm.denormalize_y(torch.from_numpy(yn), st).numpy(),
        np.asarray(jnorm.denormalize_y(jnp.asarray(yn), sj)),
        rtol=1e-5, atol=1e-4)
