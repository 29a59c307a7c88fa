"""Per-frame rollout dashboard video — the test.py deliverable (counterpart
of unet_convlstm_tpu/viz/rollout_video.py).

A 2x3 dashboard a time step: satellite-0 input, satellite-1 input, GT
velocity, predicted velocity, satellite geometry and mask, velocities on a
SymLogNorm (linthresh 1) jet colormap (reference test.py:114-122), written
as an mp4 with ``cv2.VideoWriter`` (test.py:369-577), optional per-panel
PDFs, and the per-frame MAE/RMSE/ME (``eval.rollout.frame_errors``). The
inference is the package's rollout (``eval.rollout``).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import matplotlib

matplotlib.use("Agg")
import matplotlib.colors as mcolors  # noqa: E402
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402

from ..eval.rollout import frame_errors  # noqa: E402
from .geometry import fig_to_rgb, geometry_panel_3d, load_camera_csv  # noqa: E402


def velocity_norm(vmin: float, vmax: float, linthresh: float = 1.0):
    """SymLog jet normalization (reference test.py:114-122)."""
    return mcolors.SymLogNorm(linthresh=linthresh, linscale=1.0,
                              vmin=vmin, vmax=vmax)


def _dashboard_frame(t: int, sat0, sat1, gt, pred, mask, norm,
                     geometry_rgb: Optional[np.ndarray],
                     stats_line: str) -> np.ndarray:
    fig, axes = plt.subplots(2, 3, figsize=(15, 9))
    axes[0, 0].imshow(sat0, cmap="gray")
    axes[0, 0].set_title(f"satellite 0 — t={t}")
    axes[0, 1].imshow(sat1, cmap="gray")
    axes[0, 1].set_title("satellite 1")
    im = axes[0, 2].imshow(gt, cmap="jet", norm=norm)
    axes[0, 2].set_title("GT velocity [m/s]")
    fig.colorbar(im, ax=axes[0, 2], fraction=0.046)
    im = axes[1, 0].imshow(pred, cmap="jet", norm=norm)
    axes[1, 0].set_title("prediction [m/s]")
    fig.colorbar(im, ax=axes[1, 0], fraction=0.046)
    if geometry_rgb is not None:
        axes[1, 1].imshow(geometry_rgb)
        axes[1, 1].set_title("geometry")
    axes[1, 1].axis("off")
    axes[1, 2].imshow(mask, cmap="gray", vmin=0, vmax=1)
    axes[1, 2].set_title("mask")
    for ax in axes.ravel():
        if ax is not axes[1, 1]:
            ax.set_xticks([])
            ax.set_yticks([])
    fig.suptitle(stats_line)
    fig.tight_layout()
    rgb = fig_to_rgb(fig)
    plt.close(fig)
    return rgb


def create_rollout_video(x_seq: np.ndarray, gt_denorm: np.ndarray,
                         pred_denorm: np.ndarray, mask_seq: np.ndarray,
                         out_path: str, fps: int = 2,
                         vmin: float = -8.0, vmax: float = 8.0,
                         linthresh: float = 1.0,
                         csv_path: Optional[str] = None,
                         per_frame_pdf_dir: Optional[str] = None
                         ) -> Dict[str, List[float]]:
    """x_seq [T,2,H,W] (or [T,H,W,2]), gt/pred [T,H,W], mask [T,H,W] →
    mp4 at ``out_path``. Returns the per-frame MAE/RMSE/ME lists."""
    import cv2

    if x_seq.shape[1] != 2 and x_seq.shape[-1] == 2:
        x_seq = np.moveaxis(x_seq, -1, 1)
    T = x_seq.shape[0]
    norm = velocity_norm(vmin, vmax, linthresh)
    stats = frame_errors(gt_denorm, pred_denorm, mask_seq)
    geo = None
    times, lookup = (None, None)
    if csv_path:
        times, lookup = load_camera_csv(csv_path)

    writer = None
    try:
        for t in range(T):
            mae, rmse, me = (stats[k][t] for k in ("mae", "rmse", "me"))
            if csv_path:
                geo = geometry_panel_3d(times, lookup,
                                        times[t % len(times)])
            frame = _dashboard_frame(
                t, x_seq[t, 0], x_seq[t, 1], gt_denorm[t], pred_denorm[t],
                mask_seq[t], norm, geo,
                f"t={t}  MAE={mae:.3f}  RMSE={rmse:.3f}  ME={me:+.3f} [m/s]")
            if writer is None:
                h, w = frame.shape[:2]
                writer = cv2.VideoWriter(out_path,
                                         cv2.VideoWriter_fourcc(*"mp4v"),
                                         fps, (w, h))
            writer.write(frame[..., ::-1])  # RGB → BGR
            if per_frame_pdf_dir:
                os.makedirs(per_frame_pdf_dir, exist_ok=True)
                for name, img, kw in (
                        ("sat0", x_seq[t, 0], dict(cmap="gray")),
                        ("sat1", x_seq[t, 1], dict(cmap="gray")),
                        ("gt", gt_denorm[t], dict(cmap="jet", norm=norm)),
                        ("pred", pred_denorm[t], dict(cmap="jet",
                                                      norm=norm)),
                        ("mask", mask_seq[t], dict(cmap="gray"))):
                    fig, ax = plt.subplots(figsize=(5, 5))
                    ax.imshow(img, **kw)
                    ax.set_xticks([])
                    ax.set_yticks([])
                    fig.savefig(os.path.join(per_frame_pdf_dir,
                                             f"frame{t:03d}_{name}.pdf"),
                                bbox_inches="tight")
                    plt.close(fig)
    finally:
        if writer is not None:
            writer.release()
    return stats
