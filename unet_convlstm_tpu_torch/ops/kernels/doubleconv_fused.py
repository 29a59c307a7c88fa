"""3x3 SAME conv with a BN-normalize+ReLU prologue and a per-channel
sum/sumsq epilogue, forward: CUDA kernel and its plain PyTorch version
(counterpart of unet_convlstm_tpu/ops/pallas/doubleconv_fused.py).

    z = relu(x * pre_inv + pre_shift)        (optional prologue, f32 math)
    y = conv3x3_same(z, w) + b               (f32 accumulation, stored in x's dtype)
    sum, sumsq = per-channel f32 sums of the rounded y

The halo of the SAME padding is zero in z, not in x. The kernel
(``csrc/conv3x3_fused.cu``) is an implicit GEMM that applies the prologue
while it stages x and reduces the stats in its epilogue, so a DoubleConv's
second conv reads the first one's raw output once and nothing else.

``fused_conv3x3`` takes the plain version for tensors on the CPU. For
tensors on the card it launches the kernel or raises; it never falls back.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ...core.dtypes import full_fp32
from . import build

launches = 0   # kernel launches since the last ops.kernels.reset_launches()

_DTYPES = (torch.bfloat16, torch.float32)


def kernel_supports(cin: int, cout: int, dtype: torch.dtype) -> bool:
    """The kernel's own shape guard: 16-byte channel vectors."""
    return cin % 8 == 0 and cout % 8 == 0 and dtype in _DTYPES


def fused_conv3x3_plain(x: torch.Tensor, w: torch.Tensor,
                        b: Optional[torch.Tensor] = None,
                        pre_inv: Optional[torch.Tensor] = None,
                        pre_shift: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The same function in plain PyTorch. x NHWC, w [Cout, Cin, 3, 3]."""
    if pre_inv is not None:
        a = x.float() * pre_inv.float() + pre_shift.float()
        z = torch.clamp_min(a, 0.0).to(x.dtype)
    else:
        z = x
    # f32 conv of values already rounded to x's dtype: the f32 accumulation
    # of the kernel, rounded once after the bias
    with full_fp32():
        acc = F.conv2d(z.permute(0, 3, 1, 2).float(),
                       w.to(x.dtype).float(), None, 1, 1).permute(0, 2, 3, 1)
    if b is not None:
        acc = acc + b.float()
    y = acc.to(x.dtype)
    yf = y.float()
    return y, yf.sum(dim=(0, 1, 2)), (yf * yf).sum(dim=(0, 1, 2))


def _lib():
    fn = build.load("conv3x3_fused").conv3x3_fused_fwd
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [
            ctypes.c_void_p]
    return fn


def _check_vec(name: str, v: torch.Tensor, n: int, device) -> None:
    if v.device != device or v.dtype != torch.float32 \
            or v.shape != (n,) or not v.is_contiguous():
        raise ValueError(f"fused conv3x3 kernel: {name} must be a contiguous "
                         f"f32 [{n}] tensor on {device}, got {v.dtype} "
                         f"{tuple(v.shape)} on {v.device}")


def _launch(x, w, b, pre_inv, pre_shift):
    global launches
    if x.device.type != "cuda":
        raise ValueError(f"fused conv3x3 kernel: x on {x.device}, not CUDA")
    if x.dim() != 4 or w.dim() != 4 or w.shape[2:] != (3, 3) \
            or w.shape[1] != x.shape[3]:
        raise ValueError(f"fused conv3x3 kernel: x {tuple(x.shape)} must be "
                         f"NHWC and w {tuple(w.shape)} [Cout, Cin, 3, 3]")
    n, h, wd, cin = x.shape
    cout = w.shape[0]
    if not kernel_supports(cin, cout, x.dtype):
        raise ValueError(f"fused conv3x3 kernel takes bf16/f32 with Cin and "
                         f"Cout multiples of 8, got {x.dtype} {cin}->{cout}")
    if w.device != x.device:
        raise ValueError("fused conv3x3 kernel: w is on another device")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("fused conv3x3 kernel needs a contiguous, 16-byte "
                         "aligned NHWC x (no copy is made)")
    if n * h * wd * max(cin, cout) >= 2 ** 31:
        raise ValueError(f"fused conv3x3 kernel: {tuple(x.shape)}->{cout} "
                         "exceeds 32-bit pixel indexing")
    if b is None:
        b = torch.zeros(cout, dtype=torch.float32, device=x.device)
    _check_vec("b", b, cout, x.device)
    prologue = pre_inv is not None
    if prologue:
        _check_vec("pre_inv", pre_inv, cin, x.device)
        _check_vec("pre_shift", pre_shift, cin, x.device)
    # the kernel's K-major weight: row (3*kh + kw)*Cin + ci, column co
    wk = w.to(x.dtype).permute(2, 3, 1, 0).reshape(9 * cin, cout).contiguous()
    fn = _lib()
    y = torch.empty((n, h, wd, cout), dtype=x.dtype, device=x.device)
    s = torch.zeros(cout, dtype=torch.float32, device=x.device)
    q = torch.zeros(cout, dtype=torch.float32, device=x.device)
    rc = fn(x.data_ptr(), wk.data_ptr(), b.data_ptr(),
            pre_inv.data_ptr() if prologue else None,
            pre_shift.data_ptr() if prologue else None,
            y.data_ptr(), s.data_ptr(), q.data_ptr(),
            n, h, wd, cin, cout, int(prologue),
            int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream(x.device).cuda_stream)
    launches += 1
    if rc != 0:
        raise RuntimeError(f"conv3x3_fused_fwd launch failed: CUDA error {rc}")
    return y, s, q


class _FusedConv3x3(torch.autograd.Function):
    """The kernel as an autograd node. Its backward (torch's conv grads, as
    the JAX backward uses XLA's) comes with the training slice."""

    @staticmethod
    def forward(ctx, x, w, b, pre_inv, pre_shift):
        return _launch(x, w, b, pre_inv, pre_shift)

    @staticmethod
    def backward(ctx, gy, gs, gq):
        raise NotImplementedError("training slice: the fused conv3x3 "
                                  "backward is not ported yet")


def fused_conv3x3(x: torch.Tensor, w: torch.Tensor,
                  b: Optional[torch.Tensor] = None,
                  pre_inv: Optional[torch.Tensor] = None,
                  pre_shift: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x [N,H,W,Cin] NHWC; w [Cout, Cin, 3, 3]; b [Cout] f32 or None;
    pre_inv / pre_shift [Cin] f32 (both or neither). Returns (y [N,H,W,Cout]
    in x's dtype, sum [Cout] f32, sumsq [Cout] f32). The sums are always
    computed; eval-mode callers ignore them.

    On the CPU: the plain version. On the card: the CUDA kernel."""
    if (pre_inv is None) != (pre_shift is None):
        raise ValueError("pass both pre_inv and pre_shift, or neither")
    if x.device.type == "cpu":
        return fused_conv3x3_plain(x, w, b, pre_inv, pre_shift)
    return _FusedConv3x3.apply(x, w, b, pre_inv, pre_shift)
