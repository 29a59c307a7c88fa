"""PSNR and SSIM: the port's eval/image_metrics.py against the JAX
package's on the same numpy inputs, at every input rank both accept
(2-D, 3-D, NHWC, and more than four dims flattened into the batch).
Tolerance 1e-5 relative: both compute in f32, the mean filters sum in
another order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_convlstm_tpu.eval.image_metrics import psnr as j_psnr
from unet_convlstm_tpu.eval.image_metrics import ssim as j_ssim
from unet_convlstm_tpu_torch.eval import psnr, ssim

SHAPES = {"2d": (20, 18), "3d": (3, 16, 17), "nhwc": (2, 16, 16, 3),
          "5d": (2, 3, 12, 14, 1)}


def _pair(shape, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.random(shape).astype(np.float32)
    b = np.clip(a + 0.1 * rng.standard_normal(shape), 0, 1).astype(np.float32)
    return a, b


@pytest.mark.parametrize("rank", sorted(SHAPES))
def test_ssim_and_psnr_match_jax(rank):
    a, b = _pair(SHAPES[rank])
    s_t = ssim(torch.from_numpy(a), torch.from_numpy(b)).item()
    s_j = float(j_ssim(jnp.asarray(a), jnp.asarray(b)))
    assert abs(s_t - s_j) <= 1e-5 * abs(s_j), (s_t, s_j)
    p_t = psnr(torch.from_numpy(a), torch.from_numpy(b)).item()
    p_j = float(j_psnr(jnp.asarray(a), jnp.asarray(b)))
    assert abs(p_t - p_j) <= 1e-5 * abs(p_j), (p_t, p_j)


def test_identical_images_and_data_range():
    a, b = _pair((16, 16), seed=1)
    t = torch.from_numpy(a)
    assert abs(ssim(t, t).item() - 1.0) < 1e-6
    assert psnr(t, t).item() == pytest.approx(120.0)        # mse floor 1e-12
    s_t = ssim(t * 255, torch.from_numpy(b) * 255, data_range=255.0).item()
    s_j = float(j_ssim(jnp.asarray(a) * 255, jnp.asarray(b) * 255,
                       data_range=255.0))
    assert abs(s_t - s_j) <= 1e-5 * abs(s_j)
    p_t = psnr(torch.from_numpy(a), torch.from_numpy(b).double(),
               data_range=2.0).item()
    p_j = float(j_psnr(jnp.asarray(a), jnp.asarray(b), data_range=2.0))
    assert abs(p_t - p_j) <= 1e-5 * abs(p_j)
