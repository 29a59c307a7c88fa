"""Viewer of the legacy pre-rendered samples (counterpart of
unet_convlstm_tpu/viz/legacy_viewer.py; reference
visualizing_clouds_dataset.py).

``PKLSequenceDataset`` groups the legacy sample pkls (keys ``tensors``
[2,3,H,W], ``target``, ``target_slice`` [8+,1?,H,W], ``envelope``) by
location into sliding windows (numpy only). ``animate_sequence`` draws a
window as a multi-panel mp4: the camera views, the top-cloud W target, the
W slices and the envelope (matplotlib and cv2; without them it says so and
returns None).
"""

from __future__ import annotations

import glob
import os
import pickle
from typing import List, Optional

import numpy as np

from .optional import not_drawn, pyplot, video_writer


class PKLSequenceDataset:
    """Sliding windows over legacy sample pkls grouped by location."""

    def __init__(self, folder: str, seq_len: int = 20, overlap: int = 10):
        self.seq_len = seq_len
        stride = seq_len - overlap
        by_loc = {}
        for f in sorted(glob.glob(os.path.join(folder, "*.pkl"))):
            parts = os.path.basename(f).split("_")
            t = int(parts[-3])
            loc = f"{parts[-2]}_{parts[-1].split('.')[0]}"
            by_loc.setdefault(loc, {})[t] = f
        self.windows: List[List[str]] = []
        for tm in by_loc.values():
            times = sorted(tm)
            for i in range(0, len(times) - seq_len + 1, stride):
                self.windows.append([tm[t] for t in times[i:i + seq_len]])

    def __len__(self) -> int:
        return len(self.windows)

    def load(self, idx: int) -> List[dict]:
        out = []
        for path in self.windows[idx]:
            with open(path, "rb") as f:
                out.append(pickle.load(f))
        return out


def animate_sequence(dataset: PKLSequenceDataset, idx: int, out_path: str,
                     fps: int = 2) -> Optional[str]:
    """15-panel animation of window ``idx``: 3 camera views, top-cloud W,
    envelope, 8 W slices (the reference's layout) → mp4."""
    if not_drawn("legacy sequence video", "matplotlib", "cv2"):
        return None
    from .geometry import fig_to_rgb

    plt = pyplot()
    writer = None
    try:
        for t, d in enumerate(dataset.load(idx)):
            tensors = np.asarray(d["tensors"])
            views = tensors[0] if tensors.ndim == 4 else tensors
            slices = np.asarray(d["target_slice"])
            target = np.asarray(d.get("target", slices[-1]))
            envelope = np.asarray(d.get("envelope",
                                        np.zeros(views.shape[-2:])))

            fig, axes = plt.subplots(3, 5, figsize=(20, 12))
            for i in range(min(3, views.shape[0])):
                axes[0, i].imshow(views[i], cmap="gray")
                axes[0, i].set_title(f"camera {i} — t={t}")
            lim = np.nanpercentile(np.abs(target), 99) or 1.0
            axes[0, 3].imshow(np.squeeze(target), cmap="jet",
                              vmin=-lim, vmax=lim)
            axes[0, 3].set_title("top-cloud W")
            axes[0, 4].imshow(np.squeeze(envelope), cmap="viridis")
            axes[0, 4].set_title("envelope")
            for s in range(min(8, slices.shape[0])):
                ax = axes[1 + s // 5, s % 5]
                sl = np.squeeze(slices[s])
                if sl.ndim == 3:
                    sl = sl[0]
                ax.imshow(sl, cmap="jet", vmin=-lim, vmax=lim)
                ax.set_title(f"W slice {s}")
            for ax in axes.ravel():
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
