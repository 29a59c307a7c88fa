"""Satellite-geometry panels rendered to RGB buffers (counterpart of
unet_convlstm_tpu/viz/geometry.py).

``load_camera_csv`` reads an overpass CSV into satellite positions per
time (the caster's ENU transform, reference
create_video_dashboard3d_from_samples.py:18-36), and the 3-D / 2-D
scatter panels render into image buffers for the rollout dashboard.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402

from ..datagen.overpass import camera_schedule, read_overpass_csv  # noqa: E402


def load_camera_csv(csv_path: str) -> Tuple[List[float],
                                            Dict[float, List[np.ndarray]]]:
    """{utc_time: [sat position (m), ...]} with the caster ENU transform."""
    times, schedule = camera_schedule(read_overpass_csv(csv_path))
    lookup = {t: [v.caster_camera_m()[0] for v in schedule[t]]
              for t in times}
    return times, lookup


def fig_to_rgb(fig) -> np.ndarray:
    fig.canvas.draw()
    buf = np.asarray(fig.canvas.buffer_rgba())[..., :3]
    return buf.copy()


def geometry_panel_3d(times: List[float], lookup, current_time: float,
                      figsize=(4, 4)) -> np.ndarray:
    """3-D scatter of the overpass track with the active time highlighted."""
    fig = plt.figure(figsize=figsize)
    ax = fig.add_subplot(111, projection="3d")
    for t in times:
        for pos in lookup[t]:
            km = np.abs(pos) / 1000.0
            active = (t == current_time)
            ax.scatter(km[0], km[1], pos[2] / 1000.0,
                       c="red" if active else "gray",
                       s=60 if active else 12)
    ax.scatter([0], [0], [0], c="blue", marker="^", s=80)  # cloud site
    ax.set_xlabel("|x| [km]")
    ax.set_ylabel("|y| [km]")
    ax.set_zlabel("z [km]")
    ax.set_title(f"satellites @ t={current_time:g}")
    rgb = fig_to_rgb(fig)
    plt.close(fig)
    return rgb


def geometry_panel_2d(times: List[float], lookup, current_time: float,
                      figsize=(4, 4)) -> np.ndarray:
    fig, ax = plt.subplots(figsize=figsize)
    for t in times:
        for pos in lookup[t]:
            active = (t == current_time)
            ax.scatter(abs(pos[0]) / 1000.0, pos[2] / 1000.0,
                       c="red" if active else "gray",
                       s=60 if active else 12)
    ax.set_xlabel("|x| [km]")
    ax.set_ylabel("altitude [km]")
    ax.set_title(f"track @ t={current_time:g}")
    rgb = fig_to_rgb(fig)
    plt.close(fig)
    return rgb
