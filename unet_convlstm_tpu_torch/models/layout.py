"""Sequence-flatten layout (counterpart of unet_convlstm_tpu/models/layout.py).

The encoder and decoder run on all T·B frames at once, as one [T*B, h, w,
c] or [B*T, h, w, c] tensor; only the recurrences walk time. Two layouts,
chosen per call (``flat_layout``):

``"time"`` (default): time-major, row t*B + b. Every recurrence boundary
    is a free reshape.
``"batch"``: batch-major, row b*T + t. The flatten keeps the batch axis
    major (the JAX package's layout for a 'data'-sharded batch, where it
    keeps every reshape device-local); each recurrence boundary pays a
    [B, T] <-> [T, B] transpose.

BatchNorm's batch statistics reduce over all T·B frames either way, so
both layouts compute the same function, up to the order of the sums.
Both model families depend on this contract; it is kept in one place,
with ``remat_call``, the two families' ``remat`` switch.
"""

from __future__ import annotations

import torch
import torch.utils.checkpoint

LAYOUTS = ("time", "batch")


def _check(layout: str) -> None:
    if layout not in LAYOUTS:
        raise ValueError(f"unknown flat layout {layout!r} "
                         "(expected 'time' or 'batch')")


def flatten_seq(x_seq: torch.Tensor, layout: str = "time") -> torch.Tensor:
    """[B, T, h, w, c] → flattened frames for the conv path: [T*B, ...]
    (row t*B + b) for "time", [B*T, ...] (row b*T + t) for "batch";
    dense NHWC whatever x_seq's strides (the kernels take no strided
    input, and a library conv keeps its input's memory format)."""
    _check(layout)
    B, T = x_seq.shape[0], x_seq.shape[1]
    if layout == "time":
        x_seq = x_seq.transpose(0, 1)
    return x_seq.reshape(T * B, *x_seq.shape[2:]).contiguous()


def unflatten_seq(y_flat: torch.Tensor, B: int, T: int,
                  layout: str = "time") -> torch.Tensor:
    """Flattened frames → [B, T, h, w, c] (inverse of flatten_seq)."""
    _check(layout)
    if layout == "time":
        return y_flat.reshape(T, B, *y_flat.shape[1:]).transpose(0, 1)
    return y_flat.reshape(B, T, *y_flat.shape[1:])


def to_time_major(x_flat: torch.Tensor, B: int, T: int,
                  layout: str = "time") -> torch.Tensor:
    """Flattened frames → [T, B, h, w, c] for the recurrences: a free
    reshape in "time", a transpose in "batch"."""
    _check(layout)
    if layout == "time":
        return x_flat.reshape(T, B, *x_flat.shape[1:])
    return x_flat.reshape(B, T, *x_flat.shape[1:]).transpose(0, 1)


def to_batch_major(x_tm: torch.Tensor, B: int, T: int,
                   layout: str = "time") -> torch.Tensor:
    """[T, B, h, w, c] → flattened frames (inverse of to_time_major; the
    name is the JAX package's)."""
    _check(layout)
    if layout == "time":
        return x_tm.reshape(T * B, *x_tm.shape[2:])
    return x_tm.transpose(0, 1).reshape(B * T, *x_tm.shape[2:])


def remat_call(remat: bool, fn, *args):
    """``fn(*args)``, under ``torch.utils.checkpoint`` when ``remat`` (the
    JAX package's ``jax.checkpoint``): the activations inside ``fn`` are
    recomputed in the backward instead of kept. Non-reentrant, so the
    kernels' autograd nodes and any collective run again in the backward
    as in the forward; what the recomputation returns besides them (the
    BatchNorm statistics) is discarded, the first forward's stand."""
    if not remat:
        return fn(*args)
    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)
