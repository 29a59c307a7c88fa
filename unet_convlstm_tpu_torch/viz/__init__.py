"""Figures, videos and data checks (counterpart of unet_convlstm_tpu/viz/).

* ``figures``         — the get_metrics.py figure suite from an
                        ``EvalReport``.
* ``rollout_video``   — the per-frame rollout dashboard mp4 (test.py).
* ``geometry``        — satellite-geometry panels.
* ``dashboard3d``     — the 3-D satellite-geometry dashboard across time
                        folders.
* ``sequences_video`` — the mask-threshold tuning video.
* ``legacy_viewer``   — the legacy sample pkls' windows and animation.
* ``checks``          — divergence, map/render spot check, β-volume figure,
                        dataset stats.
* ``viewers``         — Moving-MNIST animation, sample panel, pkl and .nc
                        browsers.

Importing this package imports neither matplotlib nor cv2 (the card's
machine has no matplotlib). ``checks``, ``viewers``, ``dashboard3d``,
``sequences_video``, ``legacy_viewer`` and ``save_metrics_figures`` below
import them where they draw and otherwise say what they did not draw
(``optional``); ``figures``, ``geometry`` and ``rollout_video`` import
matplotlib when imported.
"""

from .checks import (dataset_stats, divergence_check,  # noqa: F401
                     spot_check_maps, volume_check)
from .optional import not_drawn


def save_metrics_figures(report, out_dir: str, prefix: str = "metrics",
                         formats=("pdf",)):
    """``figures.save_metrics_figures``, imported at the call: {name: path}
    of the files written, {} (said) without matplotlib."""
    if not_drawn("metrics figures", "matplotlib"):
        return {}
    from .figures import save_metrics_figures as draw

    return draw(report, out_dir, prefix, formats)
