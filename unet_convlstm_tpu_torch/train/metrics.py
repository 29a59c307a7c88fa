"""Metric sums reduced on the device (counterpart of
unet_convlstm_tpu/train/metrics.py).

Each step reduces its denormalized errors to four f32 scalars on the
device — count, |err| sum, err² sum, err sum — and only those cross to the
host, at the end of an epoch, as MAE, RMSE, ME (bias) and the error's
standard deviation in physical units.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class MetricSums(NamedTuple):
    count: torch.Tensor     # f32 scalar
    abs_sum: torch.Tensor
    sq_sum: torch.Tensor
    err_sum: torch.Tensor


def metric_sums_init(device=None) -> MetricSums:
    z = torch.zeros((), dtype=torch.float32, device=device)
    return MetricSums(z, z, z, z)


def metric_sums_update(acc: MetricSums, pred_denorm: torch.Tensor,
                       y_denorm: torch.Tensor,
                       mask: Optional[torch.Tensor] = None,
                       use_mask: bool = True) -> MetricSums:
    """Add the denormalized errors (only the valid pixels when masking is
    on)."""
    diff = (pred_denorm - y_denorm).float()
    if use_mask and mask is not None:
        m = torch.broadcast_to(mask.float(), diff.shape)
        count = m.sum()
        abs_sum = (diff.abs() * m).sum()
        sq_sum = (diff * diff * m).sum()
        err_sum = (diff * m).sum()
    else:
        count = torch.tensor(float(diff.numel()), dtype=torch.float32,
                             device=diff.device)
        abs_sum = diff.abs().sum()
        sq_sum = (diff * diff).sum()
        err_sum = diff.sum()
    return MetricSums(acc.count + count, acc.abs_sum + abs_sum,
                      acc.sq_sum + sq_sum, acc.err_sum + err_sum)


def metric_sums_finalize(acc: MetricSums) -> dict:
    """→ {'mae', 'rmse', 'me', 'err_std'} floats (all 0.0 when the count is
    0)."""
    count = float(acc.count)
    if count == 0:
        return {"mae": 0.0, "rmse": 0.0, "me": 0.0, "err_std": 0.0}
    mae = float(acc.abs_sum) / count
    mse = float(acc.sq_sum) / count
    me = float(acc.err_sum) / count
    var = max(mse - me * me, 0.0)
    return {"mae": mae, "rmse": mse ** 0.5, "me": me, "err_std": var ** 0.5}
