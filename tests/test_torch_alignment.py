"""Multi-view alignment (unet_convlstm_tpu_torch/datagen/alignment.py)
against the JAX package on the CPU.

The camera matrices and the homography are the same float64 numpy in both
packages: bit-equal. The bilinear warp runs in f32 on the device: within
1e-5 of the image's max (the homography product and the divisions round
otherwise than XLA's fused jit, which moves the sample point by an ulp).
Pixels whose source coordinate is NaN (the homography's w = 0) are NaN in
both."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from unet_convlstm_tpu.datagen import alignment as J
from unet_convlstm_tpu_torch.datagen import alignment as P

WARP_TOL = 1e-5


@pytest.mark.parametrize("cam,target,up", [
    ([100.0, -50.0, 600e3], [0.0, 0.0, 1500.0], [0.0, 1.0, 0.0]),
    ([-747e3, 155e3, 558e3], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0]),
    ([0.0, 0.0, 600e3], [0.0, 0.0, 1500.0], [0.0, 1.0, 0.0]),
    ([0.0, 5e3, 0.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0]),   # along up
    ([0.0, 0.0, 0.0], [0.0, 0.0, 0.0], [1.0, 0.0, 0.0])])  # coincident
def test_camera_matrices_match_jax(cam, target, up):
    R, t = P.get_camera_matrices(cam, target, np.array(up))
    Rj, tj = J.get_camera_matrices(cam, target, np.array(up))
    np.testing.assert_array_equal(R, Rj)
    np.testing.assert_array_equal(t, tj)


def test_homography_matches_jax():
    rng = np.random.default_rng(0)
    src = rng.uniform(0, 64, (4, 2))
    dst = src + rng.uniform(-5, 5, (4, 2))
    H = P._homography_from_points(src, dst)
    np.testing.assert_array_equal(H, J._homography_from_points(src, dst))
    p = H @ np.array([*src[2], 1.0])
    np.testing.assert_allclose(p[:2] / p[2], dst[2], rtol=1e-10)


@pytest.mark.parametrize("src_pose", [[40e3, -30e3, 600e3],
                                      [-150e3, 90e3, 580e3]])
def test_warp_to_virtual_camera_matches_jax(src_pose):
    rng = np.random.default_rng(1)
    img = rng.random((24, 24)).astype(np.float32)
    f = 24 / (2 * np.tan(np.radians(0.5)))
    K = np.array([[f, 0, 12.0], [0, f, 12.0], [0, 0, 1]])
    args = (src_pose, [0.0, 0.0, 600e3], K, 24, 1500.0)
    got = P.warp_to_virtual_camera(img, *args, device="cpu")
    want = J.warp_to_virtual_camera(img, *args)
    assert got.shape == want.shape == (24, 24) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=WARP_TOL)
    assert (got > 0).any()


def test_bilinear_warp_zeros_outside_and_nan_where_w_is_zero():
    rng = np.random.default_rng(2)
    img = rng.random((10, 12)).astype(np.float32)
    # a shift off the image's edge, a scale, and a projective row that
    # makes w = 0 at dst pixel (3, 0)
    for H in (np.array([[1, 0, 7.5], [0, 1, -3.25], [0, 0, 1.0]]),
              np.array([[0.6, 0.1, 1.0], [0.0, 1.3, 0.5], [0, 0, 1.0]]),
              np.array([[1, 0, 0], [0, 1, 0], [-1 / 3, 0, 1.0]])):
        got = P._bilinear_warp(torch.from_numpy(img),
                               torch.tensor(H, dtype=torch.float32), (9, 11))
        want = np.asarray(J._bilinear_warp(jnp.asarray(img),
                                           jnp.asarray(H, jnp.float32),
                                           (9, 11)))
        np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(want))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=WARP_TOL)
    assert np.isnan(want).any() and (want == 0).any()
