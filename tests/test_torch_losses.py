"""The port's losses, metric sums, target normalization and Moving-MNIST
generator against the JAX package's, on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_convlstm_tpu.data import moving_mnist as jmm
from unet_convlstm_tpu.ops import losses as jlosses
from unet_convlstm_tpu.ops import normalize as jnorm
from unet_convlstm_tpu.train import metrics as jmetrics
from unet_convlstm_tpu_torch.data import moving_mnist as tmm
from unet_convlstm_tpu_torch.ops import losses as tlosses
from unet_convlstm_tpu_torch.ops import normalize as tnorm
from unet_convlstm_tpu_torch.train import metrics as tmetrics

TOL = dict(rtol=1e-6, atol=1e-6)


def _pred_target_mask(seed=0, shape=(3, 2, 9, 7, 1)):
    rng = np.random.default_rng(seed)
    y_pred = rng.standard_normal(shape).astype(np.float32)
    y = (rng.standard_normal(shape) * 0.8).astype(np.float32)
    mask = (rng.random(shape) > 0.4).astype(np.float32)
    return y_pred, y, mask


@pytest.mark.parametrize("use_mask", [True, False])
@pytest.mark.parametrize("weighted", [False, True])
def test_compute_loss_matches_jax(use_mask, weighted):
    y_pred, y, mask = _pred_target_mask()
    sw = np.array([1.0, 0.0, 1.0], np.float32) if weighted else None
    lj = jlosses.compute_loss(
        jnp.asarray(y_pred), jnp.asarray(y), jnp.asarray(mask), use_mask,
        grad_weight=0.005, sample_weight=None if sw is None
        else jnp.asarray(sw))
    lt = tlosses.compute_loss(
        torch.from_numpy(y_pred), torch.from_numpy(y),
        torch.from_numpy(mask), use_mask, grad_weight=0.005,
        sample_weight=None if sw is None else torch.from_numpy(sw))
    assert lt.dtype == torch.float32 and lt.dim() == 0
    np.testing.assert_allclose(float(lt), float(lj), **TOL)


def test_compute_loss_without_mask_and_masked_mse():
    y_pred, y, mask = _pred_target_mask(1)
    np.testing.assert_allclose(
        float(tlosses.compute_loss(torch.from_numpy(y_pred),
                                   torch.from_numpy(y), None)),
        float(jlosses.compute_loss(jnp.asarray(y_pred), jnp.asarray(y),
                                   None)), **TOL)
    np.testing.assert_allclose(
        float(tlosses.masked_mse(torch.from_numpy(y_pred),
                                 torch.from_numpy(y),
                                 torch.from_numpy(mask))),
        float(jlosses.masked_mse(jnp.asarray(y_pred), jnp.asarray(y),
                                 jnp.asarray(mask))), **TOL)


@pytest.mark.parametrize("use_mask", [True, False])
def test_metric_sums_match_jax(use_mask):
    y_pred, y, mask = _pred_target_mask(2)
    accj = jmetrics.metric_sums_update(
        jmetrics.metric_sums_init(), jnp.asarray(y_pred), jnp.asarray(y),
        jnp.asarray(mask[..., :1]), use_mask)
    acct = tmetrics.metric_sums_update(
        tmetrics.metric_sums_init(), torch.from_numpy(y_pred),
        torch.from_numpy(y), torch.from_numpy(mask[..., :1]), use_mask)
    # twice, so the accumulation is exercised
    accj = jmetrics.metric_sums_update(accj, jnp.asarray(y), jnp.asarray(
        y_pred), jnp.asarray(mask), use_mask)
    acct = tmetrics.metric_sums_update(acct, torch.from_numpy(y),
                                       torch.from_numpy(y_pred),
                                       torch.from_numpy(mask), use_mask)
    for a, b in zip(acct, accj):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-6)
    fj = jmetrics.metric_sums_finalize(accj)
    ft = tmetrics.metric_sums_finalize(acct)
    assert set(ft) == set(fj)
    for k in fj:
        np.testing.assert_allclose(ft[k], fj[k], rtol=1e-6)
    assert tmetrics.metric_sums_finalize(tmetrics.metric_sums_init()) == \
        {"mae": 0.0, "rmse": 0.0, "me": 0.0, "err_std": 0.0}


@pytest.mark.parametrize("transform", ["asinh", "signed_log", "none"])
@pytest.mark.parametrize("clip", [True, False])
def test_normalize_y_and_mask_match_jax(transform, clip):
    rng = np.random.default_rng(3)
    X = (rng.gamma(2.0, 0.7, (4, 3, 6, 5, 2))).astype(np.float32)
    Y = (rng.standard_normal((4, 3, 6, 5, 1)) * 4).astype(np.float32)
    kw = dict(y_transform=transform, clip_outliers=clip,
              lower_percentile=5.0, upper_percentile=95.0)
    sj = jnorm.compute_norm_stats(X, Y, **kw)
    st = tnorm.compute_norm_stats(X, Y, **kw)
    assert st.to_dict() == sj.to_dict()
    np.testing.assert_allclose(
        tnorm.normalize_y(torch.from_numpy(Y), st).numpy(),
        np.asarray(jnorm.normalize_y(jnp.asarray(Y), sj)), **TOL)
    mt = tnorm.compute_mask(torch.from_numpy(X), st)
    assert mt.shape == X.shape[:-1] + (1,) and mt.dtype == torch.float32
    np.testing.assert_array_equal(
        mt.numpy(), np.asarray(jnorm.compute_mask(jnp.asarray(X), sj)))


def test_generate_moving_mnist_is_byte_identical():
    bank = tmm.synthetic_digit_bank()
    assert np.array_equal(bank, jmm.synthetic_digit_bank())
    kw = dict(seq_len=6, num_samples=5, image_size=40, num_digits=3,
              digits=bank, seed=11)
    a = tmm.generate_moving_mnist(**kw)
    b = jmm.generate_moving_mnist(**kw)
    assert a.dtype == b.dtype == np.float32 and a.shape == (5, 6, 2, 40, 40)
    assert a.tobytes() == b.tobytes()
    xt, yt = tmm.moving_mnist_to_xy(a)
    xj, yj = jmm.moving_mnist_to_xy(b)
    assert xt.tobytes() == xj.tobytes() and yt.tobytes() == yj.tobytes()


def test_save_moving_mnist_npz_matches_jax(tmp_path):
    for as_xy in (True, False):
        kw = dict(seq_len=3, num_samples=2, image_size=32, seed=1,
                  as_xy=as_xy)
        pt = tmm.save_moving_mnist_npz(str(tmp_path / "t.npz"), **kw)
        pj = jmm.save_moving_mnist_npz(str(tmp_path / "j.npz"), **kw)
        with np.load(pt) as ft, np.load(pj) as fj:
            assert sorted(ft.files) == sorted(fj.files) == (
                ["X", "Y"] if as_xy else ["data"])
            for k in ft.files:
                assert ft[k].tobytes() == fj[k].tobytes()
