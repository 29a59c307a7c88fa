"""Evaluation: offline metric suites, streaming rollout, image metrics
(counterpart of unet_convlstm_tpu/eval/).

* ``metrics``       — global MAE/RMSE/bias/err-std, MAE per time step,
                      GT/pred/error histograms, balanced scatter sampling
                      (reference train/get_metrics.py).
* ``rollout``       — streaming O(T) rollout, whole-sequence rollout, and
                      the reference's O(T²) prefix re-runs.
* ``image_metrics`` — PSNR / SSIM.

No module here imports matplotlib or cv2: the figures and the video live in
``viz/``.
"""

from .image_metrics import psnr, ssim  # noqa: F401
from .metrics import EvalReport, evaluate_model  # noqa: F401
from .rollout import (frame_errors, rollout_prefix_rerun,  # noqa: F401
                      rollout_scan, rollout_streaming)
