"""matplotlib and cv2, imported only where a figure or a video is drawn.

The card's machine has neither. There every drawing call of ``viz/`` says
what it did not draw and returns None, while the numbers it computes
beside the drawing (statistics, summaries, panels in numpy) are returned
as usual.
"""

from __future__ import annotations

import importlib.util


def not_drawn(what: str, *modules: str) -> bool:
    """True, after printing "<what> not drawn: ... not installed", when one
    of ``modules`` does not import."""
    lacking = [m for m in modules if importlib.util.find_spec(m) is None]
    if lacking:
        print(f"{what} not drawn: {' and '.join(lacking)} not installed",
              flush=True)
    return bool(lacking)


def pyplot():
    """matplotlib.pyplot on the headless Agg backend."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def video_writer(out_path: str, fps: int, rgb):
    """An mp4v ``cv2.VideoWriter`` sized for the RGB frame ``rgb``."""
    import cv2

    h, w = rgb.shape[:2]
    return cv2.VideoWriter(out_path, cv2.VideoWriter_fourcc(*"mp4v"), fps,
                           (w, h))
