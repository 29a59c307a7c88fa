"""Multi-view homography alignment to a virtual camera (counterpart of
unet_convlstm_tpu/datagen/alignment.py).

Capability parity with reference ``mitsuba3/image_alignment_utils.py``:

* ``get_camera_matrices`` — R (rows right/down/forward) and t = -R·C from a
  camera position/target with an explicit world-up controlling roll
  (:8-43, including the straight-down singularity fallback).
* ``warp_to_virtual_camera`` — back-project the virtual camera's corners to
  the z=plane_height plane, re-project into the source camera, fit the
  homography and resample (:46-104). The reference resamples with
  cv2 LANCZOS4; here, as in the JAX package, the warp is a bilinear gather
  on the device (the pixel-grid mapping itself is identical).

Used by the render-debug flow (reference mitsuba3/debug.py:103-176) to check
that independently-rendered satellite views align on a common plane.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..core.dtypes import resolve_device


def get_camera_matrices(camera_pos, target_pos,
                        world_up=np.array([0.0, 1.0, 0.0])
                        ) -> Tuple[np.ndarray, np.ndarray]:
    camera_pos = np.asarray(camera_pos, np.float64)
    target_pos = np.asarray(target_pos, np.float64)
    forward = target_pos - camera_pos
    dist = np.linalg.norm(forward)
    forward = (forward / dist) if dist > 1e-6 else np.array([0.0, 0.0, -1.0])
    right = np.cross(forward, world_up)
    if np.linalg.norm(right) < 1e-6:
        right = (np.array([1.0, 0.0, 0.0]) if abs(world_up[1]) > 0.99
                 else np.array([0.0, 0.0, 1.0]))
    else:
        right = right / np.linalg.norm(right)
    down = np.cross(forward, right)
    down = down / np.linalg.norm(down)
    R = np.vstack([right, down, forward])
    t = -R @ camera_pos.reshape(3, 1)
    return R, t


def _homography_from_points(src_pts: np.ndarray, dst_pts: np.ndarray
                            ) -> np.ndarray:
    """Exact 4-point homography H with H·[xs,ys,1] ∝ [xd,yd,1] (the
    getPerspectiveTransform math, solved as an 8×8 linear system)."""
    A, b = [], []
    for (xs, ys), (xd, yd) in zip(src_pts, dst_pts):
        A.append([xs, ys, 1, 0, 0, 0, -xs * xd, -ys * xd])
        b.append(xd)
        A.append([0, 0, 0, xs, ys, 1, -xs * yd, -ys * yd])
        b.append(yd)
    h = np.linalg.solve(np.asarray(A, np.float64), np.asarray(b, np.float64))
    return np.append(h, 1.0).reshape(3, 3)


def _bilinear_warp(image: torch.Tensor, H_inv: torch.Tensor, out_hw):
    """Sample ``image`` at H_inv·(dst pixel) — bilinear, zeros outside."""
    h_out, w_out = out_hw
    H_img, W_img = image.shape
    dev = image.device
    j, i = torch.meshgrid(torch.arange(h_out, dtype=torch.float32,
                                       device=dev),
                          torch.arange(w_out, dtype=torch.float32,
                                       device=dev), indexing="ij")
    pts = torch.stack([i, j, torch.ones_like(i)], dim=-1) @ H_inv.T
    u = pts[..., 0] / pts[..., 2]
    v = pts[..., 1] / pts[..., 2]
    u0 = torch.floor(u)
    v0 = torch.floor(v)
    du = u - u0
    dv = v - v0
    zero = torch.zeros((), dtype=image.dtype, device=dev)

    def tap(vv, uu):
        inb = (uu >= 0) & (uu < W_img) & (vv >= 0) & (vv < H_img)
        # clamp in float before the cast (XLA's cast saturates and maps NaN
        # to 0; torch's is undefined there), then clip as the JAX warp does
        uu = torch.nan_to_num(uu, nan=0.0).clamp(0, W_img - 1).long()
        vv = torch.nan_to_num(vv, nan=0.0).clamp(0, H_img - 1).long()
        return torch.where(inb, image[vv, uu], zero)

    return ((1 - du) * (1 - dv) * tap(v0, u0)
            + du * (1 - dv) * tap(v0, u0 + 1)
            + (1 - du) * dv * tap(v0 + 1, u0)
            + du * dv * tap(v0 + 1, u0 + 1))


def warp_to_virtual_camera(src_image, src_pose, virtual_pose, K,
                           img_dim: int, plane_height: float, device=None):
    """Warp ``src_image`` into the virtual camera's view via the
    plane-induced homography (reference image_alignment_utils.py:46-104).
    The resampling runs on ``device`` (the card unless another is named);
    the result comes back as a numpy array."""
    world_up = np.array([0.0, 1.0, 0.0])
    target = np.array([0.0, 0.0, plane_height])
    R_v, _ = get_camera_matrices(virtual_pose, target, world_up)
    R_s, t_s = get_camera_matrices(src_pose, target, world_up)

    w = h = img_dim
    dst_corners = np.array([[0, 0], [w, 0], [w, h], [0, h]], np.float64)
    K_inv = np.linalg.inv(K)
    world_pts = []
    for px in dst_corners:
        ray = R_v.T @ (K_inv @ np.array([px[0], px[1], 1.0]))
        ray = ray / np.linalg.norm(ray)
        dz = ray[2] if abs(ray[2]) > 1e-6 else 1e-6
        s = (plane_height - virtual_pose[2]) / dz
        world_pts.append(np.asarray(virtual_pose, np.float64) + s * ray)
    cam_pts = (R_s @ np.asarray(world_pts).T + t_s).T
    src_corners = []
    for x, y, z in cam_pts:
        z = max(z, 0.1)
        src_corners.append([K[0, 0] * x / z + K[0, 2],
                            K[1, 1] * y / z + K[1, 2]])
    # dst→src mapping for the inverse warp
    H_inv = _homography_from_points(dst_corners, np.asarray(src_corners))
    dev = resolve_device(device)
    return _bilinear_warp(
        torch.as_tensor(np.asarray(src_image, np.float32), device=dev),
        torch.as_tensor(np.asarray(H_inv, np.float32), device=dev),
        (h, w)).cpu().numpy()
