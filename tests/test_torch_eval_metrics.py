"""The offline evaluation suite: the port's eval/metrics.py against the
JAX package's, FP32 policy (Pallas in interpret mode on the JAX side), on a
tiny 3-channel npz (C = 3, the WVU configuration's width of target).

Tolerances, with their reasons:
* scalars and per-channel rows: 1e-3 relative (the full model's outputs
  agree to ~1e-6; the sums run in another order);
* ``gt_hist``: exactly equal (the same ground truth through the same
  normalization, and the same per-row sample indices from the same numpy
  calls);
* the scatter's ``gt`` values: the same pixels (same count, channels and
  order), each within 1e-5 of 1 + |gt|: normalize then denormalize runs
  asinh and sinh in f32, whose XLA and torch implementations differ in the
  last bit, and the affine map to [-1, 1] and back amplifies that (1.1e-6
  measured);
* ``pred_hist``: within 0.1% of ``n_pixels`` in L1 (a prediction within
  float noise of a bin edge may move one bin);
* the histogram function alone: exactly ``jnp.histogram`` on values placed
  on edges, on both range ends, and outside the range.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_convlstm_tpu.core.dtypes import FP32_POLICY as JFP32
from unet_convlstm_tpu.data.npz_dataset import NPZSequenceDataset as JDataset
from unet_convlstm_tpu.eval.metrics import evaluate_model as j_evaluate
from unet_convlstm_tpu.models.temporal_unet import (
    TemporalUNetConfig as JConfig, temporal_unet_apply as j_apply,
    temporal_unet_init)
from unet_convlstm_tpu_torch.core.dtypes import FP32_POLICY
from unet_convlstm_tpu_torch.data.npz_dataset import NPZSequenceDataset
from unet_convlstm_tpu_torch.eval.metrics import (
    EvalReport, evaluate_model, histogram_edges, weighted_histogram)
from unet_convlstm_tpu_torch.models.temporal_unet import (
    TemporalUNetConfig, TemporalUNetDualView, temporal_unet_apply)
from unet_convlstm_tpu_torch.ops.normalize import NormStats
from unet_convlstm_tpu_torch.utils.torch_weights import state_dict_from_jax

CFG = dict(base_ch=4, out_channels=3, use_skip_lstm=True, lstm_layers=1)
N, T, HW, C = 10, 3, 16, 3


@pytest.fixture(scope="module")
def npz(tmp_path_factory):
    rng = np.random.default_rng(0)
    X = (rng.random((N, T, 2, HW, HW)) * 2.0).astype(np.float32)
    Y = (rng.standard_normal((N, T, C, HW, HW)) * 3.0).astype(np.float32)
    path = str(tmp_path_factory.mktemp("eval") / "wvu.npz")
    np.savez(path, X=X, Y=Y)
    return path


@pytest.fixture(scope="module")
def reports(npz):
    v = jax.device_get(temporal_unet_init(jax.random.PRNGKey(0),
                                          JConfig(**CFG)))
    jds = JDataset(npz)
    j_fn = functools.partial(j_apply, cfg=JConfig(**CFG), policy=JFP32,
                             use_pallas=True, use_fused_doubleconv=True)

    def j_apply_fn(variables, x, train=False):
        return j_fn(variables, x, train=train)

    idx = np.arange(N)
    kw = dict(indices=idx, batch_size=4, use_mask=True, seed=3,
              scatter_budget_per_batch=4096)
    r_j = j_evaluate(j_apply_fn, v, jds, **kw)
    ds = NPZSequenceDataset(npz, stats=NormStats.from_dict(
        jds.stats.to_dict()))
    model = TemporalUNetDualView(TemporalUNetConfig(**CFG))
    model.load_state_dict(state_dict_from_jax(v), strict=True)
    apply_fn = functools.partial(temporal_unet_apply, policy=FP32_POLICY,
                                 use_pallas=True, use_fused_doubleconv=True)
    r_t = evaluate_model(apply_fn, model.eval(), ds, **kw)
    return r_j, r_t


def test_report_scalars_and_channel_rows_match_jax(reports):
    r_j, r_t = reports
    assert isinstance(r_t, EvalReport)
    assert set(r_t.to_dict()) == set(r_j.to_dict())
    assert r_t.n_pixels == r_j.n_pixels > 0
    for k in ("mae", "rmse", "bias", "err_std"):
        assert getattr(r_t, k) == pytest.approx(getattr(r_j, k), rel=1e-3), k
    for k in ("mae_per_channel", "rmse_per_channel", "bias_per_channel",
              "err_std_per_channel", "mae_over_time"):
        a, b = getattr(r_t, k), getattr(r_j, k)
        assert a.shape == b.shape and a.shape[0] in (C, T), k
        np.testing.assert_allclose(a, b, rtol=1e-3, err_msg=k)
    np.testing.assert_array_equal(r_t.hist_bins, r_j.hist_bins)
    np.testing.assert_array_equal(r_t.err_bins, r_j.err_bins)


def test_histograms_and_scatter_match_jax(reports):
    r_j, r_t = reports
    np.testing.assert_array_equal(r_t.gt_hist, r_j.gt_hist)
    assert r_t.gt_hist.sum() > 0
    l1 = np.abs(r_t.pred_hist - r_j.pred_hist).sum()
    assert l1 <= 1e-3 * r_j.n_pixels, l1
    l1 = np.abs(r_t.err_hist - r_j.err_hist).sum()
    assert l1 <= 1e-3 * r_j.n_pixels, l1
    assert r_t.scatter_gt.shape == r_j.scatter_gt.shape
    err = np.abs(r_t.scatter_gt - r_j.scatter_gt) / (1 + np.abs(r_j.scatter_gt))
    assert err.max() <= 1e-5, err.max()
    np.testing.assert_array_equal(r_t.scatter_channel, r_j.scatter_channel)
    assert set(np.unique(r_t.scatter_channel)) == set(range(C))
    np.testing.assert_allclose(r_t.scatter_pred, r_j.scatter_pred,
                               rtol=1e-3, atol=1e-4)


def test_histogram_function_equals_jnp_histogram():
    lo, hi, bins = -10.0, 10.0, 100
    edges = histogram_edges(lo, hi, bins)
    _, j_edges = jnp.histogram(jnp.zeros(3), bins=bins, range=(lo, hi))
    np.testing.assert_array_equal(edges, np.asarray(j_edges))
    rng = np.random.default_rng(1)
    values = np.concatenate([
        edges, [lo, hi, lo - 1e-3, hi + 1e-3, -50.0, 50.0],
        np.nextafter(edges, np.float32(np.inf)),
        np.nextafter(edges, np.float32(-np.inf)),
        rng.uniform(-12, 12, 500)]).astype(np.float32)
    weights = rng.integers(0, 2, values.shape).astype(np.float32)
    j_counts, _ = jnp.histogram(jnp.asarray(values), bins=bins,
                                range=(lo, hi), weights=jnp.asarray(weights))
    t_counts = weighted_histogram(torch.from_numpy(values),
                                  torch.from_numpy(weights),
                                  torch.from_numpy(edges))
    np.testing.assert_array_equal(t_counts.numpy(), np.asarray(j_counts))


def test_multi_device_arguments_raise(npz):
    """A mesh that is no parallel.Mesh, and tensor-parallel variables
    (item 7b), raise; data parallelism runs (test_torch_parallel.py)."""
    ds = NPZSequenceDataset(npz)
    with pytest.raises(TypeError, match="parallel.Mesh"):
        evaluate_model(lambda *a, **k: None, torch.nn.Linear(1, 1), ds,
                       mesh=object())
    with pytest.raises(NotImplementedError, match="item 7b"):
        evaluate_model(lambda *a, **k: None, torch.nn.Linear(1, 1), ds,
                       variables_sharding=object())
