"""Offline evaluation suite (counterpart of unet_convlstm_tpu/eval/metrics.py).

The reference's get_metrics.py computations: global denormalized MAE /
RMSE / mean error (bias) / error std over the validation split, masked or
not; MAE per time step; GT / prediction / error histograms; the balanced
scatter (GT digitized into 0.05 m/s bins over [-8, 8], at most 1000 points
a bin); one row of each per output channel.

One batch runs on the model's device: the forward, then the global sums,
the per-time-step sums, the per-channel [4, C] sums, three weighted
histograms and a per-row gather of the sampled pixels, all reduced there
(f32); only those cross to the host, where they accumulate in float64 as
in the JAX package.

Data parallel (``mesh``, a ``parallel.Mesh`` of D ranks, as the JAX pass
shards the batch over 'data'): every rank reads each padded batch, draws
the same per-row scatter indices, and runs its B/D rows; the batch's sums
and histograms are summed over the ranks and the sampled pixels gathered
in row order, so each rank's report is the one-device report (up to the
order of the f32 sums). With ``variables_sharding`` (tensor parallel, a
mesh with ``model`` > 1 and a model narrowed by
``parallel.tensor.shard_model``) the sharded convs run column-parallel
over the model group, the model ranks of a data rank take the same rows,
and the reductions run over the data group.

The histograms follow ``jnp.histogram``'s rule exactly (``torch.histogram``
has no CUDA implementation and ``torch.histc`` takes no weights): the f32
edges of ``jnp.linspace(lo, hi, bins + 1)`` (``histogram_edges``), a
value's bin is
``searchsorted(edges, v, right=True)``, a value on the last edge goes in
the last bin, values outside [lo, hi] are dropped, and the mask weights
are summed with ``scatter_add_``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..data.npz_dataset import NPZSequenceDataset
from ..data.pipeline import SequenceLoader, pad_batch
from ..ops.normalize import (compute_mask, denormalize_y, normalize_x,
                             normalize_y)
from ..parallel.mesh import data_mesh, resolve_sharding
from ..parallel.tensor import check_sharded



@dataclasses.dataclass
class EvalReport:
    mae: float
    rmse: float
    bias: float
    err_std: float
    n_pixels: float
    mae_over_time: np.ndarray          # [T]
    hist_bins: np.ndarray              # bin edges for gt/pred histograms
    gt_hist: np.ndarray
    pred_hist: np.ndarray
    err_bins: np.ndarray
    err_hist: np.ndarray
    scatter_gt: np.ndarray             # balanced scatter sample
    scatter_pred: np.ndarray
    # one row per output channel (C = 1 for the reference's W map, 3 for
    # the WVU config); scatter_channel tags each scatter point's channel
    mae_per_channel: Optional[np.ndarray] = None        # [C]
    rmse_per_channel: Optional[np.ndarray] = None       # [C]
    bias_per_channel: Optional[np.ndarray] = None       # [C]
    err_std_per_channel: Optional[np.ndarray] = None    # [C]
    scatter_channel: Optional[np.ndarray] = None        # like scatter_gt

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        return {k: (v.tolist() if isinstance(v, np.ndarray) else v)
                for k, v in d.items()}


def histogram_edges(lo: float, hi: float, bins: int) -> np.ndarray:
    """The f32 edges ``jnp.histogram(..., bins, range=(lo, hi))`` uses, bit
    for bit: ``jnp.linspace`` computes start * (1 - step) + stop * step
    with step = iota / bins, which XLA rewrites to c = f32(1 / bins), step
    = iota * c and stop * step = iota * (stop * c), and evaluates as one
    fused multiply-add, fma(iota, stop * c, start * (1 - iota * c)); the
    last edge is ``hi`` itself. The fma is emulated in float64 (the
    product is exact there, and the sum rounds once before the rounding to
    f32)."""
    start, stop = np.float32(lo), np.float32(hi)
    c = np.float32(np.float32(1.0) / np.float32(bins))
    iota = np.arange(bins, dtype=np.float32)
    a = (start * (np.float32(1.0) - iota * c)).astype(np.float32)
    inner = (iota.astype(np.float64) * np.float64(np.float32(stop * c))
             + a.astype(np.float64)).astype(np.float32)
    return np.concatenate([inner, [stop]]).astype(np.float32)


def weighted_histogram(values: torch.Tensor, weights: torch.Tensor,
                       edges: torch.Tensor) -> torch.Tensor:
    """``jnp.histogram(values, bins=edges, weights=weights)[0]`` on the
    values' device (f32 sums): the counts of len(edges) - 1 bins."""
    v = values.reshape(-1).float()
    w = weights.reshape(-1).float()
    n = edges.numel()
    idx = torch.searchsorted(edges, v, right=True)
    idx = torch.where(v == edges[-1], n - 1, idx)
    idx = torch.where(torch.isnan(v), n, idx)          # NaN sorts last
    counts = torch.zeros(n + 1, dtype=torch.float32, device=v.device)
    counts.scatter_add_(0, idx, w)                      # slot n: dropped
    return counts[1:n]


def _model_device(model: torch.nn.Module) -> torch.device:
    for t in model.parameters():
        return t.device
    for t in model.buffers():
        return t.device
    return torch.device("cpu")


def _make_eval_batch_fn(apply_fn: Callable, stats, use_mask: bool,
                        hist_range=(-10.0, 10.0), hist_bins: int = 100,
                        err_range=(-5.0, 5.0), device=None):
    """(model, x_raw, y_raw, sample_idx [B, k], n_valid, row0) → the
    batch's reductions, on ``device``. ``n_valid``: the real rows of a
    zero-padded tail batch; ``row0``: the global index of x_raw's first row
    (a data-parallel rank's rows). Only the ``sample_idx`` pixels of each
    row are gathered for the balanced scatter."""
    edges = torch.from_numpy(histogram_edges(*hist_range, hist_bins)).to(
        device)
    err_edges = torch.from_numpy(histogram_edges(*err_range, hist_bins)).to(
        device)

    @torch.inference_mode()
    def batch_fn(model, x_raw, y_raw, sample_idx, n_valid: int,
                 row0: int = 0):
        x = normalize_x(x_raw, stats)
        y = normalize_y(y_raw, stats)
        mask = compute_mask(x_raw, stats)
        y_pred, _, _ = apply_fn(model, x, train=False)
        pred_d = denormalize_y(y_pred.float(), stats)
        gt_d = denormalize_y(y, stats)
        diff = pred_d - gt_d
        B = x_raw.shape[0]
        valid = (torch.arange(row0, row0 + B, device=diff.device)
                 < n_valid).float()
        vmask = valid.reshape((-1,) + (1,) * (diff.dim() - 1))
        if use_mask:
            m = torch.broadcast_to(mask, diff.shape).float() * vmask
        else:
            m = torch.broadcast_to(vmask, diff.shape).float()
        ad = diff.abs() * m
        sq = diff * diff * m
        dm = diff * m
        sums = torch.stack([m.sum(), ad.sum(), sq.sum(), dm.sum()])
        t_axes, c_axes = (0, 2, 3, 4), (0, 1, 2, 3)
        t_n, t_abs = m.sum(dim=t_axes), ad.sum(dim=t_axes)
        c_sums = torch.stack([m.sum(dim=c_axes), ad.sum(dim=c_axes),
                              sq.sum(dim=c_axes), dm.sum(dim=c_axes)])
        gt_hist = weighted_histogram(gt_d, m, edges)
        pred_hist = weighted_histogram(pred_d, m, edges)
        err_hist = weighted_histogram(diff, m, err_edges)
        pred_s = torch.gather(pred_d.reshape(B, -1), 1, sample_idx)
        gt_s = torch.gather(gt_d.reshape(B, -1), 1, sample_idx)
        m_s = torch.gather(m.reshape(B, -1), 1, sample_idx)
        return (sums, c_sums, t_n, t_abs, gt_hist, pred_hist, err_hist,
                pred_s, gt_s, m_s)

    return batch_fn


def _reduce_over_ranks(out, mesh):
    """A rank's batch reductions → the global batch's: the sums and
    histograms summed over the ranks (one collective), the sampled pixels
    of each row gathered in row order (another)."""
    sums, samples = out[:7], out[7:]
    flat = mesh.all_reduce(torch.cat([t.reshape(-1) for t in sums]))
    summed = [f.view_as(t) for f, t in zip(
        flat.split([t.numel() for t in sums]), sums)]
    gathered = mesh.all_gather(torch.stack(samples), dim=1).unbind()
    return (*summed, *gathered)


def balanced_scatter_sample(gt: np.ndarray, pred: np.ndarray,
                            bin_width: float = 0.05,
                            value_range=(-8.0, 8.0),
                            max_per_bin: int = 1000,
                            seed: int = 0):
    """Reference get_metrics.py:55-58,205-240: digitize GT into fixed bins,
    keep at most ``max_per_bin`` (gt, pred) pairs per bin."""
    lo, hi = value_range
    edges = np.arange(lo, hi + bin_width, bin_width)
    idx = np.digitize(gt, edges)
    rng = np.random.default_rng(seed)
    keep_gt, keep_pred = [], []
    for b in np.unique(idx):
        sel = np.flatnonzero(idx == b)
        if len(sel) > max_per_bin:
            sel = rng.choice(sel, max_per_bin, replace=False)
        keep_gt.append(gt[sel])
        keep_pred.append(pred[sel])
    if not keep_gt:
        return np.empty(0), np.empty(0)
    return np.concatenate(keep_gt), np.concatenate(keep_pred)


def evaluate_model(apply_fn: Callable, model: torch.nn.Module,
                   dataset: NPZSequenceDataset,
                   indices: Optional[np.ndarray] = None,
                   batch_size: int = 8, use_mask: bool = True,
                   hist_bins: int = 100, hist_range=(-10.0, 10.0),
                   err_range=(-5.0, 5.0),
                   scatter_budget_per_batch: int = 65536,
                   seed: int = 0, train_frac: float = 0.8,
                   split_seed: int = 42, mesh=None,
                   variables_sharding=None) -> EvalReport:
    """Full evaluation pass over ``indices`` (default: the val split replayed
    exactly as during training; pass the training config's
    train_frac/split_seed when they differ from the defaults). Runs on the
    model's device. ``apply_fn(model, x, train=False)`` returns (y, state,
    stats). The tail batch is zero-padded to ``batch_size``; each row's
    scatter sample is drawn with the JAX package's numpy calls in its order,
    so the same predictions give the same scatter pool. ``mesh``: the pass
    data parallel (see the module's docstring); ``batch_size`` must be
    divisible by its data degree. ``variables_sharding``: tensor parallel
    (see the module's docstring); its mesh stands in for a missing
    ``mesh``."""
    mesh, sharding = resolve_sharding(variables_sharding, mesh,
                                      "variables_sharding")
    mesh = data_mesh(mesh)
    if sharding is not None:
        check_sharded(model, sharding)
    if mesh is not None and mesh.model > 1:
        apply_fn = functools.partial(apply_fn, mesh=mesh)
    if mesh is not None and batch_size % mesh.data:
        raise ValueError(f"eval batch {batch_size} not divisible by mesh "
                         f"data degree {mesh.data}")
    rows = mesh.rows(batch_size) if mesh is not None else slice(None)
    if indices is None:
        _, indices = dataset.train_val_split(train_frac, split_seed)
    dev = _model_device(model)
    batch_fn = _make_eval_batch_fn(apply_fn, dataset.stats, use_mask,
                                   hist_range, hist_bins, err_range, dev)
    loader = SequenceLoader(dataset, indices, batch_size, shuffle=False)

    T = dataset.T
    C = dataset.Y.shape[2] if dataset.Y.ndim >= 3 else 1
    sums = np.zeros(4)
    c_sums = np.zeros((4, C))
    t_n = np.zeros(T)
    t_abs = np.zeros(T)
    gt_h = np.zeros(hist_bins)
    pr_h = np.zeros(hist_bins)
    er_h = np.zeros(hist_bins)
    sc_gt, sc_pred, sc_ch = [], [], []
    rng = np.random.default_rng(seed)

    for x_raw, y_raw in loader:
        x_raw, y_raw, n_valid = pad_batch(x_raw, y_raw, batch_size)
        # per-row stratified sampling: k pixels of each row's [T, H, W, C]
        row_px = int(np.prod(y_raw.shape[1:]))
        k = min(max(scatter_budget_per_batch // batch_size, 1), row_px)
        sample_idx_np = np.stack([rng.choice(row_px, k, replace=False)
                                  for _ in range(batch_size)])
        out = batch_fn(model,
                       torch.from_numpy(np.asarray(x_raw)[rows]).to(dev),
                       torch.from_numpy(np.asarray(y_raw)[rows]).to(dev),
                       torch.from_numpy(sample_idx_np[rows]).to(dev), n_valid,
                       rows.start or 0)
        if mesh is not None:
            out = _reduce_over_ranks(out, mesh)
        s, cs, tn, ta, gh, ph, eh, pred_s, gt_s, m_s = (
            t.cpu().numpy() for t in out)
        sums += s
        c_sums += cs
        t_n += tn
        t_abs += ta
        gt_h += gh
        pr_h += ph
        er_h += eh
        keep = (m_s > 0).ravel()
        if keep.any():
            sc_gt.append(gt_s.ravel()[keep])
            sc_pred.append(pred_s.ravel()[keep])
            # a row's flat layout is [T, H, W, C], C fastest
            sc_ch.append((sample_idx_np.ravel() % C)[keep])

    n = max(sums[0], 1e-12)
    mae = sums[1] / n
    mse = sums[2] / n
    bias = sums[3] / n
    err_std = max(mse - bias * bias, 0.0) ** 0.5

    gt_all = np.concatenate(sc_gt) if sc_gt else np.empty(0)
    pred_all = np.concatenate(sc_pred) if sc_pred else np.empty(0)
    ch_all = np.concatenate(sc_ch) if sc_ch else np.empty(0, np.int64)
    s_gt_parts, s_pred_parts, s_ch_parts = [], [], []
    for c in range(C):
        in_c = ch_all == c
        g, p = balanced_scatter_sample(gt_all[in_c], pred_all[in_c],
                                       seed=seed)
        s_gt_parts.append(g)
        s_pred_parts.append(p)
        s_ch_parts.append(np.full(len(g), c, np.int64))
    s_gt = np.concatenate(s_gt_parts) if s_gt_parts else np.empty(0)
    s_pred = np.concatenate(s_pred_parts) if s_pred_parts else np.empty(0)
    s_ch = np.concatenate(s_ch_parts) if s_ch_parts else np.empty(0, np.int64)

    c_n = np.maximum(c_sums[0], 1e-12)
    c_mae = c_sums[1] / c_n
    c_mse = c_sums[2] / c_n
    c_bias = c_sums[3] / c_n

    lo, hi = hist_range
    elo, ehi = err_range
    return EvalReport(
        mae=float(mae), rmse=float(mse ** 0.5), bias=float(bias),
        err_std=float(err_std), n_pixels=float(sums[0]),
        mae_over_time=t_abs / np.maximum(t_n, 1e-12),
        hist_bins=np.linspace(lo, hi, hist_bins + 1),
        gt_hist=gt_h, pred_hist=pr_h,
        err_bins=np.linspace(elo, ehi, hist_bins + 1), err_hist=er_h,
        scatter_gt=s_gt, scatter_pred=s_pred,
        mae_per_channel=c_mae, rmse_per_channel=np.sqrt(c_mse),
        bias_per_channel=c_bias,
        err_std_per_channel=np.sqrt(np.maximum(c_mse - c_bias ** 2, 0.0)),
        scatter_channel=s_ch)
