"""Training losses (counterpart of unet_convlstm_tpu/ops/losses.py).

* Weighted L1 with weight ``1 + 4*|y|^3`` (high velocities weigh more),
  normalized by the mask's weight when a mask is given and ``use_mask`` is
  on, a plain mean otherwise.
* Spatial gradient-difference L1 (finite differences along H and W, both
  cropped to the common (H-1, W-1) window), weighted ``grad_weight``.
* The overfit gate's masked MSE, ``sum(diff^2 * mask) / (sum(mask) + 1e-6)``.

Predictions and targets are [B, T, H, W, C] (NHWC); masks broadcast. All
math in f32 whatever the model's compute dtype.
"""

from __future__ import annotations

from typing import Optional

import torch


def _spatial_gradients(t: torch.Tensor):
    # t: [..., H, W, C]
    dx = t[..., :, 1:, :] - t[..., :, :-1, :]
    dy = t[..., 1:, :, :] - t[..., :-1, :, :]
    return dx, dy


def compute_loss(y_pred: torch.Tensor, y: torch.Tensor,
                 mask: Optional[torch.Tensor] = None,
                 use_mask: bool = True,
                 grad_weight: float = 0.005,
                 sample_weight: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """``sample_weight``: optional [B] 0/1 vector that excludes padded rows
    of a tail batch; all ones or None gives the plain formulas."""
    y_pred = y_pred.float()
    y = y.float()

    sw = None
    if sample_weight is not None:
        sw = sample_weight.float().reshape((-1,) + (1,) * (y.dim() - 1))

    abs_diff = torch.abs(y_pred - y)
    weight = 1.0 + 4.0 * torch.abs(y) ** 3

    def _mean(t):
        if sw is None:
            return t.mean()
        n = torch.broadcast_to(sw, t.shape).sum()
        return (t * sw).sum() / (n + 1e-8)

    if use_mask and mask is not None:
        m = mask.float()
        if sw is not None:
            m = m * sw
        num = (abs_diff * m * weight).sum()
        den = (m * weight).sum() + 1e-8
        weighted_l1 = num / den
    else:
        weighted_l1 = _mean(abs_diff * weight)

    dx_p, dy_p = _spatial_gradients(y_pred)
    dx_g, dy_g = _spatial_gradients(y)
    h_min = dy_p.shape[-3]
    w_min = dx_p.shape[-2]
    grad_diff = (torch.abs(dx_p[..., :h_min, :w_min, :]
                           - dx_g[..., :h_min, :w_min, :])
                 + torch.abs(dy_p[..., :h_min, :w_min, :]
                             - dy_g[..., :h_min, :w_min, :]))

    if use_mask and mask is not None:
        mask_c = mask[..., :h_min, :w_min, :].float()
        if sw is not None:
            mask_c = mask_c * sw
        grad_loss = (grad_diff * mask_c).sum() / (mask_c.sum() + 1e-8)
    else:
        grad_loss = _mean(grad_diff)

    return weighted_l1 + grad_weight * grad_loss


def masked_mse(y_pred: torch.Tensor, y: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    """The overfit gate's loss."""
    diff = (y_pred.float() - y.float()) ** 2
    mask = mask.float()
    return (diff * mask).sum() / (mask.sum() + 1e-6)
