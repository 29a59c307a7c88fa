"""Mask-threshold tuning video (counterpart of
unet_convlstm_tpu/viz/sequences_video.py; reference
plots/show_sequences.py): each frame shows the satellite-0 image, its
binary mask at the radiance threshold (default 1.1, the dataset's mask
definition, train/unet.py:279) and a log histogram of the pixel values with
the threshold marked (:77-111,141-197). Needs matplotlib and cv2; without
them it says so and returns None.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .optional import not_drawn, pyplot, video_writer


def create_mask_tuning_video(x_raw_seq: np.ndarray, out_path: str,
                             threshold: float = 1.1, fps: int = 2,
                             hist_bins: int = 80) -> Optional[str]:
    """x_raw_seq: [T, 2, H, W] or [T, H, W, 2] RAW (before normalization)
    frames → mp4 at ``out_path``."""
    if not_drawn("mask-tuning video", "matplotlib", "cv2"):
        return None
    from .geometry import fig_to_rgb

    plt = pyplot()
    if x_raw_seq.shape[1] != 2 and x_raw_seq.shape[-1] == 2:
        x_raw_seq = np.moveaxis(x_raw_seq, -1, 1)
    vmax = float(np.max(x_raw_seq)) or 1.0
    writer = None
    try:
        for t in range(x_raw_seq.shape[0]):
            frame0 = x_raw_seq[t, 0]
            mask = frame0 > threshold
            fig, axes = plt.subplots(1, 3, figsize=(14, 4.5))
            im = axes[0].imshow(frame0, cmap="gray", vmin=0, vmax=vmax)
            axes[0].set_title(f"satellite 0 — t={t}")
            fig.colorbar(im, ax=axes[0], fraction=0.046)
            axes[1].imshow(mask, cmap="gray", vmin=0, vmax=1)
            axes[1].set_title(f"mask (> {threshold}) — "
                              f"{mask.mean() * 100:.1f}% valid")
            vals = frame0.ravel()
            axes[2].hist(vals[vals > 0], bins=hist_bins)
            axes[2].set_yscale("log")
            axes[2].axvline(threshold, color="red", ls="--",
                            label=f"threshold {threshold}")
            axes[2].legend(fontsize=8)
            axes[2].set_title("pixel histogram")
            for ax in axes[:2]:
                ax.set_xticks([])
                ax.set_yticks([])
            fig.tight_layout()
            rgb = fig_to_rgb(fig)
            plt.close(fig)
            if writer is None:
                writer = video_writer(out_path, fps, rgb)
            writer.write(rgb[..., ::-1])
    finally:
        if writer is not None:
            writer.release()
    return out_path
