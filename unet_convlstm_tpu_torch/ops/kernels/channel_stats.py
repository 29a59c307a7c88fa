"""Per-channel sum and sum of squares: a CUDA kernel and its plain PyTorch
version (counterpart of the TPU kernel ``_sum_kernel`` with its wrapper
``pallas_stats``, scripts/perf/bn_kernel_proto.py:46-87, the BatchNorm-
statistics probe).

``channel_sum_sumsq(x)``: x channels-last, contiguous, bf16 or f32, any
number of leading axes → (Σx, Σx²) over every axis but the last, each f32
[C], accumulated in f32. ``channel_mean_meansq`` divides both by the row
count, as ``pallas_stats`` does. Unlike that wrapper, every row counts (it
drops a tail of rows that is not a multiple of its 1024-row tile) and any C
works (it needs C to divide 128).

The kernel (``csrc/channel_stats.cu``) reduces each block's rows in
registers and shared memory, then adds the blocks' partials in a fixed
order in a second pass: the result is bit-identical from run to run. A
wrapper runs the plain version for a tensor on the CPU; on the card it
launches the kernel or raises. It counts its launches.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import build

# kernel launches since the last ops.kernels.reset_launches()
launches = 0

_SMS = 132           # H100 SXM
_BLOCKS_PER_SM = 8   # row blocks in flight; each strides over the rest


def _dims(x: torch.Tensor):
    return tuple(range(x.dim() - 1))


def channel_sum_sumsq_plain(x: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The same function in plain PyTorch: upcast, square, sum."""
    xf = x.float()
    return xf.sum(_dims(x)), (xf ** 2).sum(_dims(x))


def _lib():
    fn = build.load("channel_stats").channel_sum_sumsq
    if fn.argtypes is None:
        P = ctypes.c_void_p
        fn.restype = ctypes.c_int
        fn.argtypes = [P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, P, P, P, P]
    return fn


def channel_sum_sumsq(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Σx, Σx²) per channel (the last axis), f32 [C] each. On the CPU: the
    plain version. On the card: the CUDA kernel."""
    global launches
    if x.device.type == "cpu":
        return channel_sum_sumsq_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"channel_sum_sumsq: no kernel for {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"channel_sum_sumsq takes bf16 or f32, not {x.dtype}")
    if x.dim() < 1 or not x.is_contiguous():
        raise ValueError("channel_sum_sumsq needs a contiguous channels-last "
                         f"tensor, got shape {tuple(x.shape)} strides "
                         f"{x.stride()}")
    C = x.shape[-1]
    rows = x.numel() // C if C else 0
    out = torch.empty(2, C, dtype=torch.float32, device=x.device)
    nblk = max(1, min(_SMS * _BLOCKS_PER_SM, -(-rows // 64)))
    scratch = torch.empty(2 * C * nblk, dtype=torch.float32, device=x.device)
    rc = _lib()(x.data_ptr(), rows, C, int(x.dtype == torch.bfloat16), nblk,
                scratch.data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
                torch.cuda.current_stream(x.device).cuda_stream)
    launches += 1
    if rc != 0:
        raise RuntimeError(f"channel_sum_sumsq launch failed: CUDA error {rc}")
    return out[0], out[1]


def channel_mean_meansq(x: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean, mean of squares) per channel: the sums over the row count."""
    s, q = channel_sum_sumsq(x)
    rows = x.numel() // max(x.shape[-1], 1)
    return s / rows, q / rows
