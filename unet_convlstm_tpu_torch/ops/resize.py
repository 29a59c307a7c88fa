"""Area (box-filter) resize — the replacement for cv2.INTER_AREA
(counterpart of unet_convlstm_tpu/ops/resize.py).

The reference shrinks 256x256 renders/velocity-maps to 128x128 with
``cv2.resize(..., interpolation=cv2.INTER_AREA)`` on host
(preprocessing/build_sequences.py:108-110,131). For integer downscale
factors INTER_AREA is exactly the mean over non-overlapping boxes: a
reshape and a mean.

Other ratios take the JAX package's rule, ``jax.image.resize(...,
"linear", antialias=True)``: a separable product with one weight matrix
per axis, the triangle kernel widened by the inverse scale when shrinking
(jax/_src/image/scale.py ``compute_weight_mat``). The weights are written
out here; ``torch.nn.functional.interpolate``'s antialias computes another
function. The dataset contract only uses the integer case.
"""

from __future__ import annotations

import numpy as np
import torch


def _weight_mat(n_in: int, n_out: int, device) -> torch.Tensor:
    """[n_in, n_out] f32 weights of JAX's antialiased linear resize along
    one axis (scale n_out / n_in, no translation)."""
    f32 = torch.float32
    inv = float(np.float32(1.0 / (n_out / n_in)))
    kernel_scale = max(inv, 1.0)
    sample = (torch.arange(n_out, dtype=f32, device=device) + 0.5) * \
        torch.tensor(inv, dtype=f32, device=device) - 0.5
    x = (sample[None, :] - torch.arange(n_in, dtype=f32, device=device)[
        :, None]).abs() / torch.tensor(kernel_scale, dtype=f32,
                                       device=device)
    w = (1 - x.abs()).clamp_min(0)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def area_resize(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """img: [..., H, W] on any device. Exact box-mean for integer factors;
    JAX's antialiased linear resize otherwise."""
    h, w = img.shape[-2], img.shape[-1]
    if h % out_h == 0 and w % out_w == 0:
        fh, fw = h // out_h, w // out_w
        new_shape = img.shape[:-2] + (out_h, fh, out_w, fw)
        return img.reshape(new_shape).mean(dim=(-3, -1))
    out = img
    if h != out_h:   # JAX resizes only the axes whose size changes
        out = torch.einsum("...hw,hH->...Hw", out,
                           _weight_mat(h, out_h, img.device).to(img.dtype))
    if w != out_w:
        out = torch.einsum("...hw,wW->...hW", out,
                           _weight_mat(w, out_w, img.device).to(img.dtype))
    return out
