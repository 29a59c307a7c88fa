"""Dataset normalization (counterpart of unet_convlstm_tpu/ops/normalize.py).

* X: divided by the global max of X, floored at 1.0.
* Mask: ``raw_x[channel 0] > mask_threshold``, from the raw frames.
* Y: optionally clipped to [min_vel, max_vel], transformed by
  ``asinh(y/scale)`` or ``sign(y)*log1p(|y|/scale)``, then mapped affinely
  to [-1, 1] with the transformed min/max; ``denormalize_y`` inverts it.

The statistics are computed once on the host (``compute_norm_stats``,
numpy) and frozen in ``NormStats``, the manifest a checkpoint carries; the
per-sample transforms are torch functions that run on the model's device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class NormStats:
    norm_const: float          # X divisor: max(max(X), 1.0)
    min_vel: float             # raw-space clip lower bound
    max_vel: float             # raw-space clip upper bound
    y_scale: float             # transform scale (99th pct of |Y|)
    trans_min: float           # transformed-space min (for [-1,1] affine)
    trans_max: float           # transformed-space max
    y_transform: str = "asinh"    # 'asinh' | 'signed_log' | 'none'
    clip_outliers: bool = True
    mask_threshold: float = 1.1

    def to_dict(self):
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d):
        return cls(**d)


def _transform_np(arr, transform: str, scale: float):
    if transform == "asinh":
        return np.arcsinh(arr / scale)
    if transform == "signed_log":
        return np.sign(arr) * np.log1p(np.abs(arr) / scale)
    return arr


def compute_norm_stats(X: np.ndarray, Y: np.ndarray,
                       min_y: Optional[float] = None,
                       max_y: Optional[float] = None,
                       lower_percentile: float = 0.00001,
                       upper_percentile: float = 99.99999,
                       clip_outliers: bool = True,
                       y_transform: str = "asinh",
                       y_transform_scale: Optional[float] = None,
                       y_transform_percentile: Optional[float] = 99,
                       mask_threshold: float = 1.1) -> NormStats:
    """One host-side statistics pass (the manifest's contents)."""
    norm_const = max(float(np.max(X)), 1.0)

    explicit = min_y is not None and max_y is not None
    if explicit:
        min_vel, max_vel = float(min_y), float(max_y)
    else:
        min_vel = float(np.percentile(Y, lower_percentile))
        max_vel = float(np.percentile(Y, upper_percentile))

    if y_transform_scale is not None:
        y_scale = float(y_transform_scale)
    elif y_transform_percentile is not None:
        y_scale = float(np.percentile(np.abs(Y), y_transform_percentile))
    else:
        y_scale = 1.0
    if y_scale <= 0.0:
        # mostly-zero targets give a zero percentile; asinh(y/0) is not finite
        y_scale = 1.0

    if explicit:
        trans_min = float(_transform_np(np.float64(min_vel), y_transform,
                                        y_scale))
        trans_max = float(_transform_np(np.float64(max_vel), y_transform,
                                        y_scale))
    else:
        y_trans = _transform_np(Y, y_transform, y_scale)
        trans_min = float(np.percentile(y_trans, lower_percentile))
        trans_max = float(np.percentile(y_trans, upper_percentile))
    if trans_max == trans_min:
        trans_max = trans_min + 1.0

    return NormStats(norm_const=norm_const, min_vel=min_vel, max_vel=max_vel,
                     y_scale=y_scale, trans_min=trans_min, trans_max=trans_max,
                     y_transform=y_transform, clip_outliers=clip_outliers,
                     mask_threshold=mask_threshold)


def compute_mask(x_raw: torch.Tensor, stats: NormStats) -> torch.Tensor:
    """Mask from the RAW x, channel 0, kept as a singleton channel:
    x_raw [..., H, W, C] → [..., H, W, 1] f32."""
    return (x_raw[..., 0:1] > stats.mask_threshold).float()


def normalize_x(x_raw: torch.Tensor, stats: NormStats) -> torch.Tensor:
    return x_raw / stats.norm_const


def normalize_y(y_raw: torch.Tensor, stats: NormStats) -> torch.Tensor:
    """Clip (if ``clip_outliers``), transform, then map affinely to
    [-1, 1]; f32."""
    y = y_raw
    if stats.clip_outliers:
        y = torch.clamp(y, stats.min_vel, stats.max_vel)
    if stats.y_transform == "asinh":
        y_t = torch.asinh(y / stats.y_scale)
    elif stats.y_transform == "signed_log":
        y_t = torch.sign(y) * torch.log1p(torch.abs(y) / stats.y_scale)
    else:
        y_t = y
    return (2.0 * (y_t - stats.trans_min)
            / (stats.trans_max - stats.trans_min) - 1.0).float()


def denormalize_y(y_norm: torch.Tensor, stats: NormStats) -> torch.Tensor:
    y_t = ((y_norm + 1.0) / 2.0 * (stats.trans_max - stats.trans_min)
           + stats.trans_min)
    if stats.y_transform == "asinh":
        return torch.sinh(y_t) * stats.y_scale
    if stats.y_transform == "signed_log":
        return torch.sign(y_t) * (torch.expm1(torch.abs(y_t))
                                  * stats.y_scale)
    return y_t
