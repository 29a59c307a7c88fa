"""ConvLSTM gate update, forward: CUDA kernel and its plain PyTorch version
(counterpart of unet_convlstm_tpu/ops/pallas/convlstm_fused.py).

    i, f, o = sigmoid(gates[..., 0C:1C, 1C:2C, 3C:4C]); g = tanh(gates[..., 2C:3C])
    c' = f * c + i * g ;  h' = o * tanh(c')

in f32; h' comes back in the gates' dtype, c' in f32. The kernel
(``csrc/gate_update.cu``) reads each row's 4C gate values once and keeps
every intermediate in registers.

``fused_gate_update`` takes the plain version for tensors on the CPU. For
tensors on the card it launches the kernel or raises; it never falls back.
Its gates must be channels-last rows, contiguous: the gate conv writes them
so (ops/conv.py), and the wrapper makes no copy of the 4C-wide tensor.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

launches = 0   # kernel launches since the last ops.kernels.reset_launches()


def gate_update_plain(gates: torch.Tensor, c: torch.Tensor):
    """The same function in plain PyTorch: each gate upcast to f32."""
    C = c.shape[-1]
    i, f, g, o = torch.split(gates, C, dim=-1)
    i = torch.sigmoid(i.float())
    f = torch.sigmoid(f.float())
    g = torch.tanh(g.float())
    o = torch.sigmoid(o.float())
    c_next = f * c.float() + i * g
    h_next = o * torch.tanh(c_next)
    return h_next.to(gates.dtype), c_next


def _lib():
    lib = build.load("gate_update")
    fn = lib.gate_update_fwd
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong,
                                               ctypes.c_int, ctypes.c_int,
                                               ctypes.c_void_p]
    return fn


def _check(gates: torch.Tensor, c: torch.Tensor) -> int:
    if gates.device.type != "cuda" or c.device != gates.device:
        raise ValueError(f"gate update kernel: gates on {gates.device}, "
                         f"c on {c.device}; both must be on one CUDA device")
    if gates.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"gate update kernel takes bf16 or f32 gates, "
                        f"not {gates.dtype}")
    if c.dtype != torch.float32:
        raise TypeError(f"gate update kernel takes an f32 cell, not {c.dtype}")
    C = c.shape[-1]
    if gates.shape[:-1] != c.shape[:-1] or gates.shape[-1] != 4 * C:
        raise ValueError(f"gates {tuple(gates.shape)} must be [..., 4C] "
                         f"for c {tuple(c.shape)}")
    if not (gates.is_contiguous() and c.is_contiguous()):
        raise ValueError("gate update kernel needs contiguous channels-last "
                         "gates and cell state (no copy is made)")
    return C


def _launch(gates: torch.Tensor, c: torch.Tensor):
    global launches
    C = _check(gates, c)
    fn = _lib()
    h = torch.empty(c.shape, dtype=gates.dtype, device=c.device)
    c_next = torch.empty_like(c)
    rows = c.numel() // C if C else 0
    rc = fn(gates.data_ptr(), c.data_ptr(), h.data_ptr(), c_next.data_ptr(),
            rows, C, int(gates.dtype == torch.bfloat16),
            torch.cuda.current_stream(c.device).cuda_stream)
    launches += 1
    if rc != 0:
        raise RuntimeError(f"gate_update_fwd launch failed: CUDA error {rc}")
    return h, c_next


class _GateUpdate(torch.autograd.Function):
    """The kernel as an autograd node. Its backward kernel (the TPU
    ``_bwd_kernel``) comes with the training slice."""

    @staticmethod
    def forward(ctx, gates, c):
        return _launch(gates, c)

    @staticmethod
    def backward(ctx, dh, dc):
        raise NotImplementedError("training slice: the gate update's "
                                  "backward kernel is not ported yet")


def fused_gate_update(gates: torch.Tensor, c: torch.Tensor):
    """gates [..., 4C] (bf16 or f32), c [..., C] f32 → (h', c').

    On the CPU: the plain version. On the card: the CUDA kernel."""
    if gates.device.type == "cpu" and c.device.type == "cpu":
        return gate_update_plain(gates, c)
    return _GateUpdate.apply(gates, c)
