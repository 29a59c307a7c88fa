"""Batch gather + NCHW→NHWC transpose on the host (counterpart of
unet_convlstm_tpu/data/fast_gather.py).

The training loop's host-side hot operation: ``X[indices]`` then
``moveaxis(2, -1)``. Two routes, chosen by the input alone:

* ``native`` — a C-contiguous float32 ``src``: one fused, cache-blocked
  pass over threads into the output (``native/hostio.cpp``, built with g++
  at first use; a failed build raises).
* ``numpy`` — anything else (another dtype, a strided view): numpy's two
  passes, ``gather_transpose_plain``, which is also the native route's
  reference in the tests.

``calls_by_route`` counts the calls of each route, so that a run can show
which one its batches took.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

_NTHREADS = max(1, (os.cpu_count() or 1) - 1)

# route → calls since the last reset (set the values to 0 to reset)
calls_by_route = {"native": 0, "numpy": 0}


def gather_transpose_plain(src: np.ndarray, indices: np.ndarray,
                           out: Optional[np.ndarray] = None) -> np.ndarray:
    """numpy's two passes: a fancy-index copy, then a moveaxis copy."""
    gathered = np.moveaxis(src[indices], 2, -1)
    if out is None:
        return np.ascontiguousarray(gathered, np.float32)
    out[...] = gathered
    return out


def gather_transpose(src: np.ndarray, indices: np.ndarray,
                     out: Optional[np.ndarray] = None,
                     nthreads: Optional[int] = None) -> np.ndarray:
    """src [N,T,C,H,W] → out [B,T,H,W,C] float32 for ``indices``."""
    indices = np.ascontiguousarray(indices, np.int64)
    N, T, C, H, W = src.shape
    B = len(indices)
    # the native kernel does raw pointer arithmetic: check as numpy would
    if B and (indices.min() < 0 or indices.max() >= N):
        raise IndexError(
            f"index out of range for dataset of {N} samples: "
            f"[{indices.min()}, {indices.max()}]")
    if src.dtype != np.float32 or not src.flags["C_CONTIGUOUS"]:
        calls_by_route["numpy"] += 1
        return gather_transpose_plain(src, indices, out)

    from ..native.build import load_hostio

    lib = load_hostio()
    if out is None:
        out = np.empty((B, T, H, W, C), np.float32)
    elif (out.shape != (B, T, H, W, C) or out.dtype != np.float32
          or not out.flags["C_CONTIGUOUS"]):
        # the kernel writes B*T*H*W*C floats at out's pointer: a wrong
        # buffer would corrupt the heap, not raise
        raise ValueError(
            f"out must be C-contiguous float32 {(B, T, H, W, C)}, got "
            f"{out.dtype} {out.shape} contiguous={out.flags['C_CONTIGUOUS']}")
    lib.gather_transpose_f32(src.ctypes.data, indices.ctypes.data,
                             out.ctypes.data, B, T, C, H, W,
                             int(nthreads or _NTHREADS))
    calls_by_route["native"] += 1
    return out
