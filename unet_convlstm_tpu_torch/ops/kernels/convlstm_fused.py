"""ConvLSTM gate update, forward and backward: CUDA kernels and their plain
PyTorch versions (counterpart of unet_convlstm_tpu/ops/pallas/convlstm_fused.py).

    i, f, o = sigmoid(gates[..., 0C:1C, 1C:2C, 3C:4C]); g = tanh(gates[..., 2C:3C])
    c' = f * c + i * g ;  h' = o * tanh(c')

in f32; h' comes back in the gates' dtype, c' in f32. The forward kernel
(``csrc/gate_update.cu``) reads each row's 4C gate values once and keeps
every intermediate in registers. ``gate_update_plan`` picks its route from
the shape, dtype and alignment alone, before the launch: the vector route
(16-byte vectors of 8 bf16 or 4 f32 channels) where C and every base
address allow it, else the scalar route. As the JAX custom VJP, the
autograd node saves only (gates, c) and the backward kernel
(``csrc/gate_update_bwd.cu``) recomputes the activations from them.

``fused_gate_update`` runs the same autograd node on every device: on the
CPU with the plain forward and backward, on the card with the kernels,
which it launches or raises; it never falls back. Its gates must be
channels-last rows, contiguous: the gate conv writes them so (ops/conv.py),
and the wrapper makes no copy of the 4C-wide tensor.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional

import torch

from . import build

# kernel launches since the last ops.kernels.reset_launches()
launches = 0        # forward
bwd_launches = 0    # backward
ROUTES = ("vector", "scalar")
launches_by_route = dict.fromkeys(ROUTES, 0)   # the forward's, by route

SMS = 132                 # an H100 SXM's streaming multiprocessors
BLOCKS_PER_SM = 4         # the vector kernel's __launch_bounds__(256, 4)
THREADS = 256             # a block of either route (csrc: kThreads)
SCALAR_BLOCKS_PER_SM = 16


@dataclasses.dataclass(frozen=True)
class Plan:
    """How one forward call runs on the card: the route, the channels a
    thread takes as one 16-byte vector (1 on the scalar route), and the
    launch's blocks of THREADS threads (the kernels stride over what one
    pass of the grid does not cover)."""
    route: str
    vec: int
    blocks: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=256)    # a pure function of a few ints
def gate_update_plan(rows: int, C: int, dtype: torch.dtype,
                     aligned: bool) -> Plan:
    """The forward's route and launch for gates [rows, 4C] of ``dtype``.

    The vector route takes C a multiple of the vector (8 bf16 channels or 4
    f32 ones, 16 bytes) with ``aligned`` base addresses (gates and c on
    16-byte boundaries) and fewer than 2^31 vectors, one vector a thread,
    at most four blocks an SM (one wave); anything else takes the scalar
    route, one element a thread."""
    vec = 8 if dtype == torch.bfloat16 else 4
    total = rows * C
    if C % vec or not aligned or total // vec >= 2 ** 31:
        return Plan("scalar", 1,
                    min(_cdiv(total, THREADS), SMS * SCALAR_BLOCKS_PER_SM))
    return Plan("vector", vec,
                min(_cdiv(total // vec, THREADS), SMS * BLOCKS_PER_SM))


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


def gate_update_bwd_plain(gates: torch.Tensor, c: torch.Tensor,
                          dh: torch.Tensor,
                          dc_out: Optional[torch.Tensor] = None):
    """The backward in plain PyTorch, line by line the TPU ``_bwd_kernel``:
    the activations recomputed in f32 from (gates, c); dh rounded to the
    gates' dtype first, as the JAX VJP does. ``dc_out`` None is zero.
    Returns (dgates in the gates' dtype, dc f32)."""
    C = c.shape[-1]
    g_all = gates.float()
    i = torch.sigmoid(g_all[..., 0 * C:1 * C])
    f = torch.sigmoid(g_all[..., 1 * C:2 * C])
    g = torch.tanh(g_all[..., 2 * C:3 * C])
    o = torch.sigmoid(g_all[..., 3 * C:4 * C])
    c = c.float()
    c_next = f * c + i * g
    tc = torch.tanh(c_next)
    dh = dh.to(gates.dtype).float()
    dc_next = dh * o * (1.0 - tc * tc)
    if dc_out is not None:
        dc_next = dc_out.float() + dc_next
    dgates = torch.cat([dc_next * g * i * (1.0 - i),
                        dc_next * c * f * (1.0 - f),
                        dc_next * i * (1.0 - g * g),
                        dh * tc * o * (1.0 - o)], dim=-1)
    return dgates.to(gates.dtype), dc_next * f


def _lib(source: str, symbol: str, n_ptr: int, n_plan: int = 0):
    """The C entry point ``symbol`` of ``csrc/<source>.cu``: ``n_ptr``
    pointers, then rows, C, is_bf16, ``n_plan`` ints of the plan and the
    stream."""
    fn = getattr(build.load(source), symbol)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [
            ctypes.c_longlong] + [ctypes.c_int] * (2 + n_plan) + [
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


def plan_for(gates: torch.Tensor, c: torch.Tensor) -> Plan:
    """The plan of one forward call on these tensors (h and c' are fresh
    allocations, 16-byte aligned)."""
    C = c.shape[-1]
    rows = c.numel() // C if C else 0
    return gate_update_plan(rows, C, gates.dtype, gates.data_ptr() % 16 == 0
                            and c.data_ptr() % 16 == 0)


def _launch(gates: torch.Tensor, c: torch.Tensor):
    global launches
    C = _check(gates, c)
    h = torch.empty(c.shape, dtype=gates.dtype, device=c.device)
    c_next = torch.empty_like(c)
    rows = c.numel() // C if C else 0
    p = plan_for(gates, c)
    if p.blocks == 0:                 # nothing to compute: no launch
        return h, c_next
    fn = _lib("gate_update", "gate_update_fwd", 4, n_plan=2)
    rc = fn(gates.data_ptr(), c.data_ptr(), h.data_ptr(), c_next.data_ptr(),
            rows, C, int(gates.dtype == torch.bfloat16),
            ROUTES.index(p.route), p.blocks,
            torch.cuda.current_stream(c.device).cuda_stream)
    launches += 1
    launches_by_route[p.route] += 1
    if rc != 0:
        raise RuntimeError(f"gate_update_fwd launch failed: CUDA error {rc}")
    return h, c_next


def _launch_bwd(gates, c, dh, dc_out):
    """dh and dc_out arrive as autograd made them (dh often a channel slice
    of the concat's gradient): both are C wide and made contiguous here.
    dgates is written contiguous, channels-last like the gates, so the gate
    conv's gradients read it without a copy."""
    global bwd_launches
    C = _check(gates, c)
    dh = dh.to(gates.dtype).contiguous()
    if dh.shape != c.shape or (dc_out is not None
                               and dc_out.shape != c.shape):
        raise ValueError(f"gate update backward: dh {tuple(dh.shape)} and "
                         f"dc_out must have c's shape {tuple(c.shape)}")
    if dc_out is not None:
        dc_out = dc_out.to(device=c.device, dtype=torch.float32).contiguous()
    fn = _lib("gate_update_bwd", "gate_update_bwd", 6)
    dgates = torch.empty_like(gates)
    dc = torch.empty_like(c)
    rows = c.numel() // C if C else 0
    rc = fn(gates.data_ptr(), c.data_ptr(), dh.data_ptr(),
            dc_out.data_ptr() if dc_out is not None else None,
            dgates.data_ptr(), dc.data_ptr(), rows, C,
            int(gates.dtype == torch.bfloat16),
            torch.cuda.current_stream(c.device).cuda_stream)
    bwd_launches += 1
    if rc != 0:
        raise RuntimeError(f"gate_update_bwd launch failed: CUDA error {rc}")
    return dgates, dc


def _on_cpu(*ts: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in ts)


class _GateUpdate(torch.autograd.Function):
    """The gate update as an autograd node with the JAX VJP's residuals:
    only (gates, c) are saved. Gradients that autograd does not produce
    (the last step's cell, unused by the loss) stay None and are not
    read, rather than materialized as zeros."""

    @staticmethod
    def forward(ctx, gates, c):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(gates, c)
        if _on_cpu(gates, c):
            return gate_update_plain(gates, c)
        return _launch(gates, c)

    @staticmethod
    def backward(ctx, dh, dc_out):
        gates, c = ctx.saved_tensors
        if dh is None and dc_out is None:
            return None, None
        if dh is None:
            dh = torch.zeros(c.shape, dtype=gates.dtype, device=c.device)
        return gate_update_bwd(gates, c, dh, dc_out)


def gate_update_bwd(gates: torch.Tensor, c: torch.Tensor, dh: torch.Tensor,
                    dc_out: Optional[torch.Tensor] = None):
    """The gate update's backward: (gates, c, dh, dc_out or None) →
    (dgates, dc). On the CPU: the plain version. On the card: the CUDA
    kernel."""
    if _on_cpu(gates, c):
        return gate_update_bwd_plain(gates, c, dh, dc_out)
    return _launch_bwd(gates, c, dh, dc_out)


def fused_gate_update(gates: torch.Tensor, c: torch.Tensor):
    """gates [..., 4C] (bf16 or f32), c [..., C] f32 → (h', c').

    On the CPU: the plain forward and backward. On the card: the CUDA
    kernels."""
    return _GateUpdate.apply(gates, c)
