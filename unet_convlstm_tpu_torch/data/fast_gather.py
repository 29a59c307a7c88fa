"""Batch gather + NCHW→NHWC transpose on the host (counterpart of
unet_convlstm_tpu/data/fast_gather.py).

The training loop's host-side hot operation: ``X[indices]`` then
``moveaxis(2, -1)``. The JAX package also has a fused native pass
(native/hostio.cpp); the port has numpy's two passes only (the native path
is queued in ROADMAP.md, queue A item 9).
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def gather_transpose(src: np.ndarray, indices: np.ndarray,
                     out: Optional[np.ndarray] = None) -> np.ndarray:
    """src [N,T,C,H,W] → out [B,T,H,W,C] float32 for ``indices``."""
    indices = np.ascontiguousarray(indices, np.int64)
    N = src.shape[0]
    if len(indices) and (indices.min() < 0 or indices.max() >= N):
        raise IndexError(
            f"index out of range for dataset of {N} samples: "
            f"[{indices.min()}, {indices.max()}]")
    gathered = np.moveaxis(src[indices], 2, -1)
    if out is None:
        return np.ascontiguousarray(gathered, np.float32)
    out[...] = gathered
    return out
