"""Int8 convolution with int32 accumulation and a fused dequant and bias
epilogue: a CUDA kernel (K8, ``csrc/conv_int8.cu``) and its plain PyTorch
version (counterpart of the int8 convolutions of
unet_convlstm_tpu/ops/quant.py:215-227 and :259-271, which XLA runs as
``conv_general_dilated`` with ``preferred_element_type=int32``; there is no
Pallas kernel behind them and PyTorch has none on CUDA).

``conv_int8(x_q, w_q, w_s, x_s, bias, stride, pads, out_dtype)``: x_q NHWC
int8, w_q OIHW int8 (read as OHWI, so a channels-last weight is used as it
lies), w_s f32 [O], x_s an f32 scalar tensor on x's device, bias f32 [O] or
None, ``pads`` ((top, bottom), (left, right)) →
``float(acc) * (x_s * w_s) + bias`` in ``out_dtype`` (bf16 or f32), NHWC.
``conv_transpose_int8`` is the 2x2 stride-2 transposed conv of the UNet's
``Up`` with a torch-layout weight [in, out, 2, 2] and scales per output
channel (axis 2 of the JAX package's HWOI kernel).

The plain version is an exact integer convolution: ``F.conv2d`` in float64
on the integer values (|acc| <= 18,432 * 127^2 < 2^53, so every partial sum
is exact in any order), rounded once to f32, then the same epilogue. It
serves the CPU and the tests, and is the kernel's reference on the card,
where ``plain_reference()`` asks for it explicitly. Otherwise a CUDA tensor
launches the kernel or raises; there is no fallback. The wrapper counts its
launches, by loader route (``vec``: Cin a multiple of 16, 16-byte staging;
``gather``: any other Cin, the flat K gathered byte by byte).
"""

from __future__ import annotations

import contextlib
import ctypes
import threading
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import build

# kernel launches since the last ops.kernels.reset_launches()
launches = 0
ROUTES = ("vec", "gather")
launches_by_route = dict.fromkeys(ROUTES, 0)

Pads = Sequence[Tuple[int, int]]
_plain_on_device = threading.local()


@contextlib.contextmanager
def plain_reference():
    """Inside this block (in this thread), ``conv_int8`` and
    ``conv_transpose_int8`` compute with the plain version on any device:
    the reference a check on the card holds the kernel against. No entry
    point of the package enters it."""
    prev = getattr(_plain_on_device, "on", False)
    _plain_on_device.on = True
    try:
        yield
    finally:
        _plain_on_device.on = prev


def _use_plain(x: torch.Tensor) -> bool:
    return x.device.type == "cpu" or getattr(_plain_on_device, "on", False)


def out_size(size: int, k: int, stride: int, pad: Tuple[int, int]) -> int:
    return (size + pad[0] + pad[1] - k) // stride + 1


def _epilogue(acc: torch.Tensor, w_s: torch.Tensor, x_s: torch.Tensor,
              bias: Optional[torch.Tensor], out_dtype: torch.dtype
              ) -> torch.Tensor:
    """acc NHWC float64 holding exact integers → the dequantized output,
    contiguous NHWC as the kernel writes it: one rounding to f32 (as int32
    → f32), the scale x_s * w_s, the bias, each a separately rounded f32
    operation."""
    y = acc.to(torch.float32) * (x_s * w_s)
    if bias is not None:
        y = y + bias
    return y.to(out_dtype).contiguous()


def int8_acc_plain(x_q: torch.Tensor, w_q: torch.Tensor, stride: int,
                   pads: Pads) -> torch.Tensor:
    """The int32 accumulator of ``conv_int8``, NHWC, as exact integers in
    float64."""
    (pt, pb), (pl, pr) = pads
    xt = F.pad(x_q.permute(0, 3, 1, 2).to(torch.float64), (pl, pr, pt, pb))
    return F.conv2d(xt, w_q.to(torch.float64), None, stride).permute(
        0, 2, 3, 1)


def conv_int8_plain(x_q: torch.Tensor, w_q: torch.Tensor, w_s: torch.Tensor,
                    x_s: torch.Tensor, bias: Optional[torch.Tensor],
                    stride: int, pads: Pads,
                    out_dtype: torch.dtype) -> torch.Tensor:
    """The same function in plain PyTorch: an exact float64 convolution of
    the integer values, then the epilogue."""
    return _epilogue(int8_acc_plain(x_q, w_q, stride, pads), w_s, x_s, bias,
                     out_dtype)


def conv_transpose_int8_plain(x_q: torch.Tensor, w_q: torch.Tensor,
                              w_s: torch.Tensor, x_s: torch.Tensor,
                              bias: Optional[torch.Tensor], stride: int,
                              out_dtype: torch.dtype) -> torch.Tensor:
    """Transposed conv (weight [in, out, k, k], VALID) in plain PyTorch:
    exact in float64, then the epilogue with scales per output channel."""
    acc = F.conv_transpose2d(x_q.permute(0, 3, 1, 2).to(torch.float64),
                             w_q.to(torch.float64), None, stride)
    return _epilogue(acc.permute(0, 2, 3, 1), w_s, x_s, bias, out_dtype)


def _lib():
    fn = build.load("conv_int8").conv_int8
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 16 + [
            ctypes.c_void_p]
    return fn


def route_for(x_q: torch.Tensor, w_gemm: torch.Tensor) -> str:
    """The loader of one launch: 16-byte staging where Cin is a multiple of
    16 and both base addresses are 16-byte aligned, else the byte gather."""
    C = x_q.shape[-1]
    aligned = x_q.data_ptr() % 16 == 0 and w_gemm.data_ptr() % 16 == 0
    return "vec" if C % 16 == 0 and aligned else "gather"


def _check(x_q, w_gemm, w_s, x_s, bias, out_dtype, cols):
    dev = x_q.device
    if dev.type != "cuda":
        raise ValueError(f"conv_int8: no kernel for {dev}")
    if x_q.dtype != torch.int8 or w_gemm.dtype != torch.int8:
        raise TypeError(f"conv_int8 takes int8 x and w, not {x_q.dtype} "
                        f"and {w_gemm.dtype}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"conv_int8 writes bf16 or f32, not {out_dtype}")
    for name, t, n in (("w_s", w_s, cols), ("bias", bias, cols),
                       ("x_s", x_s, None)):
        if t is None:
            continue
        if t.device != dev or t.dtype != torch.float32:
            raise ValueError(f"conv_int8: {name} must be f32 on {dev}, got "
                             f"{t.dtype} on {t.device}")
        if n is not None and tuple(t.shape) != (n,):
            raise ValueError(f"conv_int8: {name} {tuple(t.shape)} must be "
                             f"[{n}]")
        if n is None and t.numel() != 1:
            raise ValueError("conv_int8: x_s must be one scalar")
    if x_q.dim() != 4 or not x_q.is_contiguous():
        raise ValueError("conv_int8 needs a contiguous NHWC x, got shape "
                         f"{tuple(x_q.shape)} strides {x_q.stride()}")
    if x_q.numel() >= 2 ** 31:
        raise ValueError("conv_int8: x has 2^31 elements or more")


def _launch(x_q, w_gemm, w_s, x_s, bias, y, KH, KW, stride, pad_h, pad_w,
            P, Q, cols, cout, up2):
    global launches
    N, H, W, C = x_q.shape
    if y.numel() == 0:
        return y
    route = route_for(x_q, w_gemm)
    rc = _lib()(x_q.data_ptr(), w_gemm.data_ptr(), w_s.data_ptr(),
                x_s.data_ptr(), bias.data_ptr() if bias is not None else None,
                y.data_ptr(), N, H, W, C, KH, KW, stride, pad_h, pad_w, P, Q,
                cols, cout, int(route == "vec"), int(up2),
                int(y.dtype == torch.bfloat16),
                torch.cuda.current_stream(x_q.device).cuda_stream)
    launches += 1
    launches_by_route[route] += 1
    if rc != 0:
        raise RuntimeError(f"conv_int8 launch failed: CUDA error {rc}")
    return y


def conv_int8(x_q: torch.Tensor, w_q: torch.Tensor, w_s: torch.Tensor,
              x_s: torch.Tensor, bias: Optional[torch.Tensor], stride: int,
              pads: Pads, out_dtype: torch.dtype) -> torch.Tensor:
    """int8 NHWC conv with an OIHW int8 weight → NHWC ``out_dtype``. On the
    CPU: the plain version. On the card: the kernel."""
    if _use_plain(x_q):
        return conv_int8_plain(x_q, w_q, w_s, x_s, bias, stride, pads,
                               out_dtype)
    O, I, KH, KW = w_q.shape
    if x_q.dim() != 4 or x_q.shape[-1] != I:
        raise ValueError(f"conv_int8: x {tuple(x_q.shape)} does not have "
                         f"the weight's {I} input channels")
    w_gemm = w_q.permute(0, 2, 3, 1)          # OHWI: no copy if channels-last
    if not w_gemm.is_contiguous():
        w_gemm = w_gemm.contiguous()
    _check(x_q, w_gemm, w_s, x_s, bias, out_dtype, O)
    N, H, W, _ = x_q.shape
    (pt, pb), (pl, pr) = pads
    P, Q = out_size(H, KH, stride, (pt, pb)), out_size(W, KW, stride, (pl, pr))
    y = torch.empty((N, max(P, 0), max(Q, 0), O), dtype=out_dtype,
                    device=x_q.device)
    return _launch(x_q, w_gemm, w_s, x_s, bias, y, KH, KW, stride, pt, pl,
                   P, Q, O, O, up2=False)


def conv_transpose_int8(x_q: torch.Tensor, w_q: torch.Tensor,
                        w_s: torch.Tensor, x_s: torch.Tensor,
                        bias: Optional[torch.Tensor], stride: int,
                        out_dtype: torch.dtype) -> torch.Tensor:
    """int8 NHWC transposed conv, weight [in, out, k, k] → NHWC
    ``out_dtype``. On the CPU: the plain version (any k, stride). On the
    card: the kernel, which takes k = stride = 2 (the UNet's upsampler) as
    a 1x1 GEMM to 4*out columns."""
    if _use_plain(x_q):
        return conv_transpose_int8_plain(x_q, w_q, w_s, x_s, bias, stride,
                                         out_dtype)
    I, O, KH, KW = w_q.shape
    if (KH, KW, stride) != (2, 2, 2):
        raise ValueError(f"conv_transpose_int8: the kernel takes a 2x2 "
                         f"stride-2 transposed conv, not {KH}x{KW} stride "
                         f"{stride}")
    if x_q.dim() != 4 or x_q.shape[-1] != I:
        raise ValueError(f"conv_transpose_int8: x {tuple(x_q.shape)} does "
                         f"not have the weight's {I} input channels")
    # rows (a, b, o): the output pixel (2p + a, 2q + b), channel o
    w_gemm = w_q.permute(2, 3, 1, 0).reshape(4 * O, I).contiguous()
    _check(x_q, w_gemm, w_s, x_s, bias, out_dtype, O)
    N, H, W, _ = x_q.shape
    y = torch.empty((N, 2 * H, 2 * W, O), dtype=out_dtype, device=x_q.device)
    return _launch(x_q, w_gemm, w_s, x_s, bias, y, 1, 1, 1, 0, 0, H, W,
                   4 * O, O, up2=True)

