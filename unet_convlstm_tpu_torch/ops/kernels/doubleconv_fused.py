"""3x3 SAME conv with a BN-normalize+ReLU prologue and a per-channel
sum/sumsq epilogue: CUDA kernel and its plain PyTorch version for the
forward, torch's conv gradients for the backward (counterpart of
unet_convlstm_tpu/ops/pallas/doubleconv_fused.py).

    z = relu(x * pre_inv + pre_shift)        (optional prologue, f32 math)
    y = conv3x3_same(z, w) + b               (f32 accumulation, stored in x's dtype)
    sum, sumsq = per-channel f32 sums of the rounded y

The halo of the SAME padding is zero in z, not in x. The kernel
(``csrc/conv3x3_fused.cu``) is an implicit GEMM that applies the prologue
to x once it is staged and reduces the stats in its epilogue, so a
DoubleConv's second conv reads the first one's raw output once and nothing
else. The sums add in a fixed order (each row of blocks writes its
partials, a last pass adds them in block order), so y and the sums are the
same bits on every run, as the TPU kernel's grid-ordered sums are. ``plan`` picks its route from the shape alone, before the launch:
the Hopper route (a TMA/cp.async ring feeding ``wgmma``, split K where the
output tiles are fewer than the SMs) for the bf16 shapes it takes, the
generic route (WMMA or FMA tiles) for f32 and the rest.

``fused_conv3x3`` runs one autograd node on every device: its forward is
the plain version on the CPU and the kernel on the card, which it launches
or raises; it never falls back. Its backward is the JAX ``_bwd`` step by
step: the stats cotangents fold into dy, the prologue is recomputed, and
the conv's input and weight gradients come from torch's
``convolution_backward`` (the JAX package leaves them to XLA's conv
transposes, outside any Pallas kernel). It saves (x, y, w, inv, shift),
the JAX residuals.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ...core.dtypes import full_fp32
from . import build

launches = 0   # fused_conv3x3 calls on the card since reset_launches()
ROUTES = ("wgmma", "generic")
launches_by_route = dict.fromkeys(ROUTES, 0)   # the same calls, by route

_DTYPES = (torch.bfloat16, torch.float32)
SMS = 132                     # an H100 SXM's streaming multiprocessors
BM = 128                      # output pixels a block of either route takes
WORKSPACE_CAP = 32 << 20      # bytes of f32 split-K partials at most
MIN_CHUNKS_PER_SPLIT = 4      # K chunks a split walks at least
# the tiles csrc/conv3x3_fused.cu instantiates, (BN, BK)
_WGMMA_TILES = {(bn, bk) for bn in (16, 32, 64, 128) for bk in (16, 32, 64)}


def _stages(bk: int) -> int:
    """The ring's stages (Cfg::STAGES): 3 of 128-byte rows, else 4."""
    return 3 if bk == 64 else 4


def kernel_supports(cin: int, cout: int, dtype: torch.dtype) -> bool:
    """The kernel's own shape guard: 16-byte channel vectors."""
    return cin % 8 == 0 and cout % 8 == 0 and dtype in _DTYPES


@dataclasses.dataclass(frozen=True)
class Plan:
    """How one call runs on the card: the route, the output tile (bm pixels
    by bn channels), the K chunk bk, the ring's stages, the K splits and
    the blocks of the main kernel."""
    route: str
    bm: int
    bn: int
    bk: int
    stages: int
    splits: int
    blocks: int
    workspace_bytes: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=1024)   # a pure function of a few ints
def plan(n: int, h: int, w: int, cin: int, cout: int,
         dtype: torch.dtype) -> Plan:
    """The route and tiling of a [n, h, w, cin] -> cout conv, from the shape
    alone. The wgmma route takes bf16 with Cin % 16 == 0 and Cout 16, 32,
    64 or a multiple of 128; the tile is Cout wide up to 128 channels. A
    grid of fewer tiles than SMs splits K over blocks, to about two blocks
    per SM, as far as MIN_CHUNKS_PER_SPLIT and WORKSPACE_CAP allow."""
    if not kernel_supports(cin, cout, dtype):
        raise ValueError(f"fused conv3x3 kernel takes bf16/f32 with Cin and "
                         f"Cout multiples of 8, got {dtype} {cin}->{cout}")
    m = n * h * w
    if dtype != torch.bfloat16 or cin % 16 \
            or not (cout in (16, 32, 64) or cout % 128 == 0):
        return Plan("generic", BM, 64, 32, 1, 1,
                    _cdiv(m, BM) * _cdiv(cout, 64), 0)
    bk = 64 if cin % 64 == 0 else 32 if cin % 32 == 0 else 16
    bn = min(cout, 128)
    tiles = _cdiv(m, BM) * (cout // bn)
    splits = 1
    if 0 < tiles < SMS:
        splits = max(1, min(2 * SMS // tiles,
                            9 * cin // bk // MIN_CHUNKS_PER_SPLIT))
        while splits > 1 and splits * m * cout * 4 > WORKSPACE_CAP:
            splits -= 1
    return Plan("wgmma", BM, bn, bk, _stages(bk), splits, tiles * splits,
                4 * splits * m * cout if splits > 1 else 0)


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
    lib = build.load("conv3x3_fused")
    if lib.conv3x3_fused_fwd.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.conv3x3_fused_fwd.restype = I
        lib.conv3x3_fused_fwd.argtypes = [P] * 9 + [I] * 7 + [P]
        lib.conv3x3_fused_wgmma.restype = I
        lib.conv3x3_fused_wgmma.argtypes = [P, P, I] + [P] * 9 + [I] * 9 + [
            P]
    return lib


# conv3x3_fused_wgmma's own error codes (CUDA's are positive)
_WGMMA_ERRORS = {-1: "no cuTensorMapEncodeTiled in the CUDA driver",
                 -2: "the weight's TMA tensor map was refused",
                 -3: "a tile the source does not instantiate"}


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
    p = plan(n, h, wd, cin, cout, x.dtype)   # raises on what it cannot take
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
    lib = _lib()
    dev = x.device
    y = torch.empty((n, h, wd, cout), dtype=x.dtype, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    # each row of 128-pixel blocks writes its per-channel partials to its
    # own column; the kernel's last pass adds them in a fixed order
    part = torch.empty((2, cout, _cdiv(n * h * wd, BM)), dtype=torch.float32,
                       device=dev)
    inv_ptr = pre_inv.data_ptr() if prologue else None
    shift_ptr = pre_shift.data_ptr() if prologue else None
    if p.route == "wgmma":
        # one call: the weight's K-major copy and the zeroed sums (one prep
        # kernel, which also runs on an empty batch), the main kernel, the
        # split-K pass where splits > 1, and the sums' finishing pass
        if w.dtype not in _DTYPES or not w.is_contiguous():
            w = w.to(x.dtype).contiguous()
        wt = torch.empty((cout, 9 * cin), dtype=torch.bfloat16, device=dev)
        s = torch.empty(cout, dtype=torch.float32, device=dev)
        q = torch.empty(cout, dtype=torch.float32, device=dev)
        ws = torch.empty(p.workspace_bytes // 4, dtype=torch.float32,
                         device=dev) if p.splits > 1 else None
        rc = lib.conv3x3_fused_wgmma(
            x.data_ptr(), w.data_ptr(), int(w.dtype == torch.bfloat16),
            b.data_ptr(), inv_ptr, shift_ptr, wt.data_ptr(), y.data_ptr(),
            s.data_ptr(), q.data_ptr(), None if ws is None else ws.data_ptr(),
            part.data_ptr(), n, h, wd, cin, cout, int(prologue), p.bn, p.bk,
            p.splits, stream)
    else:
        # the kernel's K-major weight: row (3*kh + kw)*Cin + ci, column co
        wk = w.to(x.dtype).permute(2, 3, 1, 0).reshape(9 * cin,
                                                       cout).contiguous()
        # zeros: an empty batch launches nothing
        s = torch.zeros(cout, dtype=torch.float32, device=dev)
        q = torch.zeros(cout, dtype=torch.float32, device=dev)
        rc = lib.conv3x3_fused_fwd(
            x.data_ptr(), wk.data_ptr(), b.data_ptr(), inv_ptr, shift_ptr,
            y.data_ptr(), s.data_ptr(), q.data_ptr(), part.data_ptr(), n, h,
            wd, cin, cout, int(prologue), int(x.dtype == torch.bfloat16),
            stream)
    launches += 1
    launches_by_route[p.route] += 1
    if rc != 0:
        raise RuntimeError(f"conv3x3_fused ({p.route} route, {p}) failed: "
                           f"{_WGMMA_ERRORS.get(rc, f'CUDA error {rc}')}")
    return y, s, q


def fused_conv3x3_bwd(x, y, w, pre_inv, pre_shift, gy, gs, gq):
    """The JAX ``_bwd`` (ops/pallas/doubleconv_fused.py:222-274): cotangents
    (gy, gs, gq) of (y, sum, sumsq), any of them None for zero, → (dx, dw,
    db, dinv, dshift); dinv and dshift are None without a prologue. dx and
    dw come back in x's dtype, the rest in f32."""
    f32, cdt = torch.float32, x.dtype
    # d(sum)/dy = 1 and d(sumsq)/dy = 2y per channel, with the saved,
    # rounded y
    dy = gy.float() if gy is not None else torch.zeros(y.shape, dtype=f32,
                                                       device=y.device)
    if gs is not None:
        dy = dy + gs.float()
    if gq is not None:
        dy = dy + 2.0 * y.float() * gq.float()
    dy = dy.to(cdt)
    db = dy.float().sum(dim=(0, 1, 2))
    if pre_inv is not None:
        a = x.float() * pre_inv.float() + pre_shift.float()
        z = torch.clamp_min(a, 0.0).to(cdt)
    else:
        z = x
    # NCHW views of NHWC tensors: channels-last to cuDNN, no copy
    with full_fp32() if cdt == f32 else contextlib.nullcontext():
        dz, dw, _ = torch.ops.aten.convolution_backward(
            dy.permute(0, 3, 1, 2), z.permute(0, 3, 1, 2), w.to(cdt), None,
            [1, 1], [1, 1], [1, 1], False, [0, 0], 1, [True, True, False])
    dz = dz.permute(0, 2, 3, 1)
    if pre_inv is None:
        return dz.to(cdt), dw, db, None, None
    da = torch.where(a > 0.0, dz.float(), 0.0)
    return ((da * pre_inv.float()).to(cdt), dw, db,
            (da * x.float()).sum(dim=(0, 1, 2)), da.sum(dim=(0, 1, 2)))


class _FusedConv3x3(torch.autograd.Function):
    """The fused conv as an autograd node with the JAX VJP's residuals.
    Unused outputs (the sums in eval mode) get None gradients, which the
    backward skips rather than folding in zeros."""

    @staticmethod
    def forward(ctx, x, w, b, pre_inv, pre_shift):
        ctx.set_materialize_grads(False)
        if x.device.type == "cpu":
            out = fused_conv3x3_plain(x, w, b, pre_inv, pre_shift)
        else:
            out = _launch(x, w, b, pre_inv, pre_shift)
        ctx.save_for_backward(x, out[0], w, pre_inv, pre_shift)
        return out

    @staticmethod
    def backward(ctx, gy, gs, gq):
        x, y, w, pre_inv, pre_shift = ctx.saved_tensors
        if gy is None and gs is None and gq is None:
            return None, None, None, None, None
        dx, dw, db, dinv, dshift = fused_conv3x3_bwd(
            x, y, w, pre_inv, pre_shift, gy, gs, gq)
        grads = (dx, dw.to(w.dtype), db, dinv, dshift)
        # None where the input was None or takes no gradient
        return tuple(g if need else None
                     for g, need in zip(grads, ctx.needs_input_grad))


def fused_conv3x3(x: torch.Tensor, w: torch.Tensor,
                  b: Optional[torch.Tensor] = None,
                  pre_inv: Optional[torch.Tensor] = None,
                  pre_shift: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x [N,H,W,Cin] NHWC; w [Cout, Cin, 3, 3]; b [Cout] f32 or None;
    pre_inv / pre_shift [Cin] f32 (both or neither). Returns (y [N,H,W,Cout]
    in x's dtype, sum [Cout] f32, sumsq [Cout] f32). The sums are always
    computed; eval-mode callers ignore them.

    On the CPU: the plain version. On the card: the CUDA kernel. Both
    differentiate through the JAX package's backward."""
    if (pre_inv is None) != (pre_shift is None):
        raise ValueError("pass both pre_inv and pre_shift, or neither")
    return _FusedConv3x3.apply(x, w, b, pre_inv, pre_shift)
