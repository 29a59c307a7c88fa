"""Image quality metrics: PSNR and SSIM (counterpart of
unet_convlstm_tpu/eval/image_metrics.py).

SSIM is the Wang et al. formulation with a 7x7 uniform window (VALID),
C1 = (0.01 L)², C2 = (0.03 L)², computed in f32 as a depthwise mean filter
on the tensor's device.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.dtypes import full_fp32


def psnr(pred: torch.Tensor, target: torch.Tensor,
         data_range: float = 1.0) -> torch.Tensor:
    """Peak signal-to-noise ratio in dB over the whole tensor."""
    mse = torch.mean((pred.float() - target.float()) ** 2)
    return 10.0 * torch.log10((data_range ** 2)
                              / torch.clamp_min(mse, 1e-12))


def _uniform_filter(x: torch.Tensor, size: int) -> torch.Tensor:
    """Mean filter over H, W of an NHWC tensor (VALID), per channel."""
    n = x.shape[-1]
    k = torch.full((n, 1, size, size), 1.0 / (size * size),
                   dtype=x.dtype, device=x.device)
    with full_fp32():          # f32 on the card too: TF32 off
        y = F.conv2d(x.permute(0, 3, 1, 2), k, groups=n)
    return y.permute(0, 2, 3, 1)


def ssim(pred: torch.Tensor, target: torch.Tensor, data_range: float = 1.0,
         window: int = 7) -> torch.Tensor:
    """Mean SSIM. pred/target: [H, W], [N, H, W], NHWC, or more than four
    dims (the leading ones flattened into the batch); computed in f32."""
    x, y = pred.float(), target.float()
    if x.dim() == 2:
        x, y = x[None, :, :, None], y[None, :, :, None]
    elif x.dim() == 3:                       # [N, H, W]
        x, y = x[..., None], y[..., None]
    elif x.dim() > 4:
        x = x.reshape((-1,) + tuple(x.shape[-3:]))
        y = y.reshape((-1,) + tuple(y.shape[-3:]))
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    mu_x = _uniform_filter(x, window)
    mu_y = _uniform_filter(y, window)
    mu_xx = _uniform_filter(x * x, window)
    mu_yy = _uniform_filter(y * y, window)
    mu_xy = _uniform_filter(x * y, window)
    var_x = mu_xx - mu_x * mu_x
    var_y = mu_yy - mu_y * mu_y
    cov = mu_xy - mu_x * mu_y
    num = (2 * mu_x * mu_y + c1) * (2 * cov + c2)
    den = (mu_x ** 2 + mu_y ** 2 + c1) * (var_x + var_y + c2)
    return torch.mean(num / den)
