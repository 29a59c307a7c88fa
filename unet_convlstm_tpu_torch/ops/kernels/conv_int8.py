"""Int8 convolution with int32 accumulation, the activation quantizer in its
prologue and a fused dequant and bias epilogue: a CUDA kernel (K8,
``csrc/conv_int8.cu``) and its plain PyTorch version (counterpart of the
int8 convolutions of unet_convlstm_tpu/ops/quant.py:215-227 and :259-271,
which XLA runs as ``conv_general_dilated`` with
``preferred_element_type=int32``, the activation quantize fused into its
producer; there is no Pallas kernel behind them and PyTorch has none on
CUDA).

Two entries on one kernel:

* ``conv_int8(x_q, w_q, w_s, x_s, bias, stride, pads, out_dtype)``: x_q
  NHWC int8 with its scale x_s (an f32 scalar tensor on x's device);
* ``conv_int8_quant(x, w_q, w_s, x_s, bias, stride, pads, out_dtype)``: x
  NHWC float, quantized inside the kernel as ``clamp(round(x / x_s),
  ±127)`` (round half to even) with the static scale x_s, or, where x_s is
  None, with the dynamic one ``max|x| / 127`` (1 where x is all zero),
  whose max|x| is one PyTorch reduction in x's dtype and whose division
  the kernel does; no int8 activation reaches device memory.

Both take w_q OIHW int8 (read as OHWI, so a channels-last weight is used as
it lies), w_s f32 [O], bias f32 [O] or None and ``pads`` ((top, bottom),
(left, right)), and return ``float(acc) * (x_s * w_s) + bias`` in
``out_dtype`` (bf16 or f32), NHWC. ``conv_transpose_int8`` and
``conv_transpose_int8_quant`` are the 2x2 stride-2 transposed conv of the
UNet's ``Up`` with a torch-layout weight [in, out, 2, 2] and scales per
output channel (axis 2 of the JAX package's HWOI kernel).

The plain version is the quantizer of ops/quant.py in torch ops (for
``_quant``) and an exact integer convolution: ``F.conv2d`` in float64 on
the integer values (|acc| <= 18,432 * 127^2 < 2^53, so every partial sum
is exact in any order), rounded once to f32, then the same epilogue. It
serves the CPU and the tests, and is the kernel's reference on the card,
where ``plain_reference()`` asks for it explicitly. Otherwise a CUDA tensor
launches the kernel or raises; there is no fallback.

``plan`` picks the route from the shape alone: ``wgmma`` (s8 wgmma fed by
a TMA ring, split K where the output tiles are fewer than the SMs; for a
float x of a 3x3 stride-1 SAME conv the halo mode, which quantizes each
channel block's pixels once for the 9 taps) where Cin % 16 == 0, Cout % 8
== 0 and K >= 32; else the first design's ``vec`` (Cin % 16 == 0) or
``gather`` (any Cin) loader. The wrapper counts its launches, by route
(``launches_by_route``) and by entry (``launches_by_entry``: ``int8`` or
``quant``).
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import threading
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import build

# kernel launches since the last ops.kernels.reset_launches()
launches = 0
ROUTES = ("wgmma", "vec", "gather")
launches_by_route = dict.fromkeys(ROUTES, 0)
ENTRIES = ("int8", "quant")
launches_by_entry = dict.fromkeys(ENTRIES, 0)

INT8_MAX = 127.0
SMS = 132                     # an H100 SXM's streaming multiprocessors
BM = 128                      # output pixels a block takes (but wide tiles)
WORKSPACE_CAP = 32 << 20      # bytes of int32 split-K partials at most
MIN_CHUNKS_PER_SPLIT = 4      # K chunks a split walks at least
PIPE_BUDGET = 96 * 1024       # ring bytes a wgmma block (Cfg::PIPE_BUDGET)
HALO_BUDGET = 110 * 1024      # shared bytes a halo-mode block, two an SM
_X_TYPES = {torch.int8: 0, torch.bfloat16: 1, torch.float32: 2}

Pads = Sequence[Tuple[int, int]]
_plain_on_device = threading.local()


@contextlib.contextmanager
def plain_reference():
    """Inside this block (in this thread), every entry of this module
    computes with the plain version on any device: the reference a check
    on the card holds the kernel against. No entry point of the package
    enters it."""
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


# ---------------------------------------------------------------------------
# The plan: route and tiling from the shape alone
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Plan:
    """How one call runs on the card: the route, the output tile (bm pixels
    by bn GEMM columns), the K chunk bk (bytes), the ring's stages, the K
    splits, the blocks of the main kernel, the split-K workspace, and
    whether the wgmma route runs its halo mode (a 3x3 stride-1 SAME conv of
    a float x: each channel block's pixels quantized once for the 9 taps)."""
    route: str
    bm: int
    bn: int
    bk: int
    stages: int
    splits: int
    blocks: int
    workspace_bytes: int
    halo: bool = False


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _stages(bm: int, bn: int, bk: int, esize: int) -> int:
    """The ring's stages of the wgmma route (Cfg::STAGES): as many as fit
    PIPE_BUDGET beside the two s8 tiles of a float x, 2 to 4."""
    s8 = 2 * bm * bk if esize > 1 else 0
    return max(2, min(4, (PIPE_BUDGET - s8) // (bm * bk * esize + bn * bk)))


def _halo_bytes(bm: int, bn: int, bk: int, esize: int, w: int) -> int:
    """Shared bytes of a halo-mode block (HaloCfg::main_bytes): two s8
    tiles, the weight ring, the s8 halo and its x staging (BM + 2W + 2 rows,
    padded to whole passes of the block), or the epilogue's tile."""
    rpp = 256 // (bk * esize // 16)
    rows = _cdiv(bm + 2 * w + 2, rpp) * rpp
    stages = 3 if bn == 256 else 4
    pipe = 2 * bm * bk + stages * bn * bk + rows * bk * (1 + esize)
    return max(pipe, bm * (bn + 4) * 4)


def _generic(route: str, cin: int, k: int, m: int, cols: int) -> Plan:
    """The first design's plan: 128 x 64 tiles, 64-byte K steps where Cin
    is a multiple of 64 and k >= 256 on the vec loader, else 32."""
    bk = 64 if route == "vec" and cin % 64 == 0 and k >= 256 else 32
    return Plan(route, BM, 64, bk, 3, 1, _cdiv(m, BM) * _cdiv(cols, 64), 0)


@functools.lru_cache(maxsize=1024)   # a pure function of a few ints
def plan(m: int, cin: int, cols: int, cout: int, k: int,
         x_dtype: torch.dtype = torch.int8, halo_w: int = 0) -> Plan:
    """The route and tiling of a GEMM of m output pixels, ``cols`` columns
    (cout, or 4 * cout for the transposed conv) and depth k = kh * kw * cin
    with an x of ``x_dtype`` (int8, or bf16/f32 quantized in the kernel);
    ``halo_w`` > 0 says the conv is 3x3, stride 1, SAME on maps that wide.

    The wgmma route takes Cin % 16 == 0, Cout % 8 == 0 and k >= 32. The
    tile is 128 pixels by BN 128, 64 or 32 columns, or for a float x with
    256 columns or more 64 pixels by 256 (the quantizing prologue then
    quantizes each staged row for twice the columns). BK is the widest of
    128, 64 and 32 channels that stages at most 128 bytes of x a row (128
    for an int8 x, 64 for bf16, 32 for f32) and divides k, else 32. A float
    x of a 3x3 stride-1 SAME conv with Cin % 32 == 0 takes the halo mode
    where a block's shared memory stays within HALO_BUDGET (BK then divides
    Cin). A grid of fewer tiles than SMs splits K over blocks, to about two
    blocks per SM, as far as MIN_CHUNKS_PER_SPLIT (in the halo mode whole
    channel blocks) and WORKSPACE_CAP allow. The rest takes the first
    design: the vec loader where Cin % 16 == 0, else the byte gather."""
    if x_dtype not in _X_TYPES:
        raise TypeError(f"conv_int8 takes an int8, bf16 or f32 x, not "
                        f"{x_dtype}")
    esize = x_dtype.itemsize
    if cin % 16 or cout % 8 or k < 32:
        return _generic("gather" if cin % 16 else "vec", cin, k, m, cols)
    if esize > 1 and cols >= 256:
        bm, bn = 64, 256
    else:
        bm, bn = BM, 128 if cols >= 128 else 64 if cols >= 64 else 32
    halo = halo_w > 0 and esize > 1 and cin % 32 == 0
    if halo:
        bk = next((b for b in (64, 32) if b * esize <= 128 and cin % b == 0
                   and _halo_bytes(bm, bn, b, esize, halo_w) <= HALO_BUDGET),
                  0)
        halo = bk > 0
    if halo:
        stages, max_splits = (3 if bn == 256 else 4), cin // bk
    else:
        bk = next((b for b in (128, 64) if b * esize <= 128 and k % b == 0),
                  32)
        stages = _stages(bm, bn, bk, esize)
        max_splits = _cdiv(k, bk) // MIN_CHUNKS_PER_SPLIT
    tiles = _cdiv(m, bm) * _cdiv(cols, bn)
    splits = 1
    if 0 < tiles < SMS:
        splits = max(1, min(2 * SMS // tiles, max_splits))
        while splits > 1 and splits * m * cols * 4 > WORKSPACE_CAP:
            splits -= 1
    return Plan("wgmma", bm, bn, bk, stages, splits, tiles * splits,
                4 * splits * m * cols if splits > 1 else 0, halo)


def conv_plan(x_shape, w_shape, stride: int, pads: Pads,
              x_dtype: torch.dtype = torch.int8,
              transposed: bool = False) -> Plan:
    """``plan`` of one call: x NHWC, w OIHW ([in, out, 2, 2] transposed)."""
    n, h, w, cin = x_shape
    if transposed:
        cout = w_shape[1]
        return plan(n * h * w, cin, 4 * cout, cout, cin, x_dtype)
    cout, _, kh, kw = w_shape
    m = n * out_size(h, kh, stride, pads[0]) * out_size(w, kw, stride,
                                                        pads[1])
    same3 = (kh, kw, stride) == (3, 3, 1) and [tuple(q) for q in pads] == [
        (1, 1), (1, 1)]
    return plan(max(m, 0), cin, cout, cout, kh * kw * cin, x_dtype,
                w if same3 else 0)


# ---------------------------------------------------------------------------
# The plain version
# ---------------------------------------------------------------------------

def _const(v: float, like: torch.Tensor) -> torch.Tensor:
    """An f32 constant on ``like``'s device: a division by a tensor rounds
    once on every device (torch divides by a Python number as a product
    with its reciprocal on the card)."""
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def quantize_with(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Static symmetric int8: clamp(round(x / scale), ±127), in f32."""
    return torch.clamp(torch.round(x.float() / scale), -INT8_MAX,
                       INT8_MAX).to(torch.int8).contiguous()


def quantize_act(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dynamic per-tensor symmetric int8: (x_q int8, scale f32 [])."""
    x = x.float()
    amax = x.abs().amax()
    scale = torch.where(amax > 0, amax / _const(INT8_MAX, x),
                        _const(1.0, x))
    return quantize_with(x, scale), scale


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


def _quantized(x: torch.Tensor, x_s: Optional[torch.Tensor]
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain quantizer of the ``_quant`` entries: (x_q, x_s)."""
    if x_s is None:
        return quantize_act(x)
    return quantize_with(x, x_s), x_s


def conv_int8_quant_plain(x, w_q, w_s, x_s, bias, stride, pads, out_dtype):
    """``conv_int8_quant`` in plain PyTorch: the quantizer, then
    ``conv_int8_plain``."""
    x_q, x_s = _quantized(x, x_s)
    return conv_int8_plain(x_q, w_q, w_s, x_s, bias, stride, pads, out_dtype)


def conv_transpose_int8_quant_plain(x, w_q, w_s, x_s, bias, stride,
                                    out_dtype):
    """``conv_transpose_int8_quant`` in plain PyTorch."""
    x_q, x_s = _quantized(x, x_s)
    return conv_transpose_int8_plain(x_q, w_q, w_s, x_s, bias, stride,
                                     out_dtype)


# ---------------------------------------------------------------------------
# The kernel
# ---------------------------------------------------------------------------

def _lib():
    fn = build.load("conv_int8").conv_int8
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.restype = I
        fn.argtypes = [P, I, P, P, P, I, P, P, P] + [I] * 21 + [P]
    return fn


def route_plan(x: torch.Tensor, w_gemm: torch.Tensor, p: Plan, m: int,
               cols: int) -> Plan:
    """``p``, or the byte gather where a base address is off a 16-byte
    boundary (the other routes stage 16-byte vectors)."""
    if p.route == "gather" or (x.data_ptr() % 16 == 0
                               and w_gemm.data_ptr() % 16 == 0):
        return p
    return _generic("gather", x.shape[-1], w_gemm.shape[-1], m, cols)


def _check(x, w_gemm, w_s, x_s, bias, out_dtype, cols, entry):
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"conv_int8: no kernel for {dev}")
    if entry == "int8" and x.dtype != torch.int8:
        raise TypeError(f"conv_int8 takes an int8 x, not {x.dtype}")
    if entry == "int8" and x_s is None:
        raise ValueError("conv_int8: an int8 x needs its scale x_s")
    if entry == "quant" and x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"conv_int8_quant takes a bf16 or f32 x, not "
                        f"{x.dtype}")
    if w_gemm.dtype != torch.int8:
        raise TypeError(f"conv_int8 takes an int8 w, not {w_gemm.dtype}")
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
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError("conv_int8 needs a contiguous NHWC x, got shape "
                         f"{tuple(x.shape)} strides {x.stride()}")
    if x.numel() >= 2 ** 31:
        raise ValueError("conv_int8: x has 2^31 elements or more")


def _scale(x: torch.Tensor, x_s: Optional[torch.Tensor]):
    """(the scale tensor, scale_mode) of one launch: x_s (mode 0), or
    max|x| in x's dtype (1: bf16, 2: f32), one reduction, from which the
    kernel forms x_s."""
    if x_s is not None:
        return x_s, 0
    amax = torch.linalg.vector_norm(x, float("inf"))
    return amax, 1 if x.dtype == torch.bfloat16 else 2


def _launch(x, w_gemm, w_s, x_s, bias, y, KH, KW, stride, pad_h, pad_w,
            P, Q, cols, cout, up2, p: Plan, entry: str):
    global launches
    N, H, W, C = x.shape
    if y.numel() == 0:
        return y
    p = route_plan(x, w_gemm, p, N * P * Q, cols)
    scale, mode = _scale(x, x_s)
    ws = (torch.empty(p.workspace_bytes // 4, dtype=torch.int32,
                      device=x.device) if p.splits > 1 else None)
    rc = _lib()(x.data_ptr(), _X_TYPES[x.dtype], w_gemm.data_ptr(),
                w_s.data_ptr(), scale.data_ptr(), mode,
                bias.data_ptr() if bias is not None else None, y.data_ptr(),
                ws.data_ptr() if ws is not None else None,
                N, H, W, C, KH, KW, stride, pad_h, pad_w, P, Q, cols, cout,
                int(up2), int(y.dtype == torch.bfloat16),
                ROUTES.index(p.route), p.bm, p.bn, p.bk, p.splits,
                int(p.halo), torch.cuda.current_stream(x.device).cuda_stream)
    launches += 1
    launches_by_route[p.route] += 1
    launches_by_entry[entry] += 1
    if rc != 0:
        raise RuntimeError(f"conv_int8 launch failed: CUDA error {rc}")
    return y


def _conv(x, w_q, w_s, x_s, bias, stride, pads, out_dtype, entry):
    O, I, KH, KW = w_q.shape
    if x.dim() != 4 or x.shape[-1] != I:
        raise ValueError(f"conv_int8: x {tuple(x.shape)} does not have "
                         f"the weight's {I} input channels")
    w_gemm = w_q.permute(0, 2, 3, 1)          # OHWI: no copy if channels-last
    if not w_gemm.is_contiguous():
        w_gemm = w_gemm.contiguous()
    _check(x, w_gemm, w_s, x_s, bias, out_dtype, O, entry)
    N, H, W, _ = x.shape
    (pt, pb), (pl, pr) = pads
    P, Q = out_size(H, KH, stride, (pt, pb)), out_size(W, KW, stride, (pl, pr))
    y = torch.empty((N, max(P, 0), max(Q, 0), O), dtype=out_dtype,
                    device=x.device)
    p = conv_plan(x.shape, w_q.shape, stride, pads, x.dtype)
    return _launch(x, w_gemm, w_s, x_s, bias, y, KH, KW, stride, pt, pl,
                   P, Q, O, O, False, p, entry)


def _conv_transpose(x, w_q, w_s, x_s, bias, stride, out_dtype, entry):
    I, O, KH, KW = w_q.shape
    if (KH, KW, stride) != (2, 2, 2):
        raise ValueError(f"conv_transpose_int8: the kernel takes a 2x2 "
                         f"stride-2 transposed conv, not {KH}x{KW} stride "
                         f"{stride}")
    if x.dim() != 4 or x.shape[-1] != I:
        raise ValueError(f"conv_transpose_int8: x {tuple(x.shape)} does "
                         f"not have the weight's {I} input channels")
    # rows (a, b, o): the output pixel (2p + a, 2q + b), channel o
    w_gemm = w_q.permute(2, 3, 1, 0).reshape(4 * O, I).contiguous()
    _check(x, w_gemm, w_s, x_s, bias, out_dtype, O, entry)
    N, H, W, _ = x.shape
    y = torch.empty((N, 2 * H, 2 * W, O), dtype=out_dtype, device=x.device)
    p = conv_plan(x.shape, w_q.shape, 2, ((0, 0), (0, 0)), x.dtype, True)
    return _launch(x, w_gemm, w_s, x_s, bias, y, 1, 1, 1, 0, 0, H, W,
                   4 * O, O, True, p, entry)


def _float_x(x: torch.Tensor) -> torch.Tensor:
    """x as the quantizing entry's kernel reads it: bf16 or f32 as it is
    (other float dtypes in f32, which the plain quantizer computes in
    anyway), contiguous NHWC."""
    if x.dtype not in (torch.bfloat16, torch.float32):
        x = x.float()
    return x.contiguous()


def conv_int8(x_q: torch.Tensor, w_q: torch.Tensor, w_s: torch.Tensor,
              x_s: torch.Tensor, bias: Optional[torch.Tensor], stride: int,
              pads: Pads, out_dtype: torch.dtype) -> torch.Tensor:
    """int8 NHWC conv with an OIHW int8 weight → NHWC ``out_dtype``. On the
    CPU: the plain version. On the card: the kernel."""
    if _use_plain(x_q):
        return conv_int8_plain(x_q, w_q, w_s, x_s, bias, stride, pads,
                               out_dtype)
    return _conv(x_q, w_q, w_s, x_s, bias, stride, pads, out_dtype, "int8")


def conv_int8_quant(x: torch.Tensor, w_q: torch.Tensor, w_s: torch.Tensor,
                    x_s: Optional[torch.Tensor],
                    bias: Optional[torch.Tensor], stride: int, pads: Pads,
                    out_dtype: torch.dtype) -> torch.Tensor:
    """Float NHWC x, quantized with the static scale x_s (or the dynamic
    one where x_s is None), conv with an OIHW int8 weight → NHWC
    ``out_dtype``. On the CPU: the plain version. On the card: the kernel,
    which quantizes x in its prologue."""
    if _use_plain(x):
        return conv_int8_quant_plain(x, w_q, w_s, x_s, bias, stride, pads,
                                     out_dtype)
    return _conv(_float_x(x), w_q, w_s, x_s, bias, stride, pads, out_dtype,
                 "quant")


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
    return _conv_transpose(x_q, w_q, w_s, x_s, bias, stride, out_dtype,
                           "int8")


def conv_transpose_int8_quant(x: torch.Tensor, w_q: torch.Tensor,
                              w_s: torch.Tensor, x_s: Optional[torch.Tensor],
                              bias: Optional[torch.Tensor], stride: int,
                              out_dtype: torch.dtype) -> torch.Tensor:
    """``conv_transpose_int8`` of a float x, quantized as in
    ``conv_int8_quant``."""
    if _use_plain(x):
        return conv_transpose_int8_quant_plain(x, w_q, w_s, x_s, bias, stride,
                                               out_dtype)
    return _conv_transpose(_float_x(x), w_q, w_s, x_s, bias, stride,
                           out_dtype, "quant")
