"""Sequence-flatten layout (counterpart of unet_convlstm_tpu/models/layout.py).

The encoder and decoder run on all T·B frames at once, as one time-major
[T*B, h, w, c] tensor (row t*B + b); only the recurrences walk time, and
every recurrence boundary is a free reshape. (The JAX package's
batch-major layout serves its data-parallel mesh and comes with the
multi-device slice.)
"""

from __future__ import annotations

import torch


def flatten_seq(x_seq: torch.Tensor) -> torch.Tensor:
    """[B, T, h, w, c] → [T*B, h, w, c] for the conv path."""
    B, T = x_seq.shape[0], x_seq.shape[1]
    return x_seq.transpose(0, 1).reshape(T * B, *x_seq.shape[2:])


def unflatten_seq(y_flat: torch.Tensor, B: int, T: int) -> torch.Tensor:
    """[T*B, h, w, c] → [B, T, h, w, c] (inverse of flatten_seq)."""
    return y_flat.reshape(T, B, *y_flat.shape[1:]).transpose(0, 1)


def to_time_major(x_flat: torch.Tensor, B: int, T: int) -> torch.Tensor:
    """[T*B, h, w, c] → [T, B, h, w, c] for the recurrences."""
    return x_flat.reshape(T, B, *x_flat.shape[1:])


def to_batch_major(x_tm: torch.Tensor, B: int, T: int) -> torch.Tensor:
    """[T, B, h, w, c] → [T*B, h, w, c] (inverse of to_time_major)."""
    return x_tm.reshape(T * B, *x_tm.shape[2:])
