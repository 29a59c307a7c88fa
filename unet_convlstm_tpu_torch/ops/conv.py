"""Conv / pool / BatchNorm primitives, NHWC activations, torch-layout weights
(counterpart of unet_convlstm_tpu/ops/conv.py).

Activations are NHWC tensors as in the JAX package. Weights keep torch's
layouts (Conv2d OIHW, ConvTranspose2d (in, out, kh, kw)), because the
modules carry the reference's torch state dict. A convolution sees the
NHWC tensor as an NCHW tensor in channels-last memory format, so cuDNN
reads and writes channels-last and no layout copy is made.

These stay on torch's own convolutions: the JAX package leaves them to XLA,
outside any Pallas kernel. ``conv2d`` and ``conv_transpose2d`` take either
a weight tensor (and bias) or the conv module itself; a module holding int8
weights (``ops/quant.quantize_model``) goes to the int8 path, K8 on the
card, as the JAX functions dispatch on ``w_q``.

With a tensor-parallel ``mesh``, a weight that is this rank's block of
output channels (``parallel.tensor.shard_model``) runs column-parallel:
the rank's output block is gathered over the model group before the
whole bias is added (``parallel/tensor.py``).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..core.dtypes import DEFAULT_POLICY, Policy, full_fp32
from ..parallel.mesh import global_sum
from ..parallel.tensor import copy_to_model, gather_from_model, shard_mesh

Padding = Union[str, int, Sequence[Tuple[int, int]]]


def _to_nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# Parameter holders (the reference's module names; init as torch's defaults)
# ---------------------------------------------------------------------------

def _uniform(shape, bound: float, generator: Optional[torch.Generator]):
    t = torch.rand(shape, generator=generator, dtype=torch.float32)
    return (t * 2.0 - 1.0) * bound


class Conv2d(nn.Module):
    """Holds ``weight`` [out, in, k, k] and ``bias`` [out]. Kaiming-uniform
    (a = sqrt(5)) and fan-in-uniform bias, as torch's and the JAX package's
    initializers, drawn from an explicit generator on the CPU."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3,
                 bias: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        fan_in = in_ch * kernel_size * kernel_size
        bound = 1.0 / math.sqrt(fan_in)   # gain sqrt(1/3) * sqrt(3/fan_in)
        self.weight = nn.Parameter(_uniform(
            (out_ch, in_ch, kernel_size, kernel_size), bound, generator))
        self.bias = (nn.Parameter(_uniform((out_ch,), bound, generator))
                     if bias else None)


class ConvTranspose2d(nn.Module):
    """Holds ``weight`` [in, out, k, k] and ``bias`` [out] (torch layout;
    the JAX package stores the same kernel HWOI as ``wt``)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 2,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        bound = 1.0 / math.sqrt(out_ch * kernel_size * kernel_size)
        self.weight = nn.Parameter(_uniform(
            (in_ch, out_ch, kernel_size, kernel_size), bound, generator))
        self.bias = nn.Parameter(_uniform((out_ch,), bound, generator))


# ---------------------------------------------------------------------------
# Conv2d
# ---------------------------------------------------------------------------

def _backward_in_fp32(y: torch.Tensor, policy: Policy) -> torch.Tensor:
    """Under an f32 policy, run the backward of the convolution that made
    ``y`` with TF32 off, as its forward ran: autograd runs it after the
    forward has left ``policy.precision()``, under torch's global flags
    (cuDNN's TF32 is on by default)."""
    if policy.compute_dtype != torch.float32 or y.grad_fn is None:
        return y
    entered = []

    def enter(grad):
        entered.append(full_fp32())
        entered[-1].__enter__()

    def leave(grad_inputs, grad_outputs):
        entered.pop().__exit__(None, None, None)

    # a hook on y runs just before its node, ahead of the node's pre-hooks
    y.register_hook(enter)
    y.grad_fn.register_hook(leave)
    return y


def _same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def resolve_pads(hw: Tuple[int, int], kernel: Tuple[int, int], stride: int,
                 padding: Padding) -> List[Tuple[int, int]]:
    """[(top, bottom), (left, right)] for "SAME", "VALID", an int or
    explicit pairs."""
    if padding == "SAME":
        return [_same_pads(hw[0], kernel[0], stride),
                _same_pads(hw[1], kernel[1], stride)]
    if padding == "VALID":
        return [(0, 0), (0, 0)]
    if isinstance(padding, int):
        return [(padding, padding), (padding, padding)]
    return [tuple(p) for p in padding]


def conv2d(x: torch.Tensor, weight: Union[torch.Tensor, nn.Module],
           bias: Optional[torch.Tensor] = None, stride: int = 1,
           padding: Padding = "SAME",
           policy: Policy = DEFAULT_POLICY, mesh=None) -> torch.Tensor:
    """NHWC conv with an OIHW weight, or with a conv module (its weight
    and bias). ``padding``: "SAME", "VALID", an int, or explicit [(lo,
    hi), (lo, hi)]. The output stays in the compute dtype and the bias is
    added in that dtype after the conv, as in the JAX package (not inside
    cuDNN's f32 epilogue). A module with int8 weights runs
    ``ops.quant.conv2d_int8``. ``mesh``: a weight shard runs
    column-parallel over its model group (the module's docstring)."""
    if isinstance(weight, nn.Module):
        if not weight.weight.is_floating_point():
            from .quant import conv2d_int8
            pads = resolve_pads(x.shape[1:3], weight.weight.shape[2:],
                                stride, padding)
            return conv2d_int8(weight, x, stride, pads,
                               out_dtype=policy.compute_dtype)
        weight, bias = weight.weight, weight.bias
    tp = shard_mesh(weight, mesh)
    w = policy.cast_param(weight)
    x = policy.cast_input(x)
    if tp is not None:
        x = copy_to_model(x, tp)
    pads = resolve_pads(x.shape[1:3], w.shape[2:], stride, padding)
    xt = _to_nchw(x)
    (ph0, ph1), (pw0, pw1) = pads
    if ph0 == ph1 and pw0 == pw1:
        pad_arg = (ph0, pw0)
    else:
        xt = F.pad(xt, (pw0, pw1, ph0, ph1))
        pad_arg = (0, 0)
    with policy.precision():
        y = _backward_in_fp32(F.conv2d(xt, w, None, stride, pad_arg), policy)
    y = _to_nhwc(y)
    if tp is not None:
        y = gather_from_model(y, tp)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


# ---------------------------------------------------------------------------
# ConvTranspose2d (kernel 2, stride 2: the UNet decoder upsampler)
# ---------------------------------------------------------------------------

def conv_transpose2d(x: torch.Tensor, weight: Union[torch.Tensor, nn.Module],
                     bias: Optional[torch.Tensor] = None, stride: int = 2,
                     policy: Policy = DEFAULT_POLICY,
                     mesh=None) -> torch.Tensor:
    """NHWC transposed conv, weight [in, out, kh, kw] or a transposed-conv
    module; for kernel = stride = 2 it doubles H and W. Bias added in the
    compute dtype. A module with int8 weights runs
    ``ops.quant.conv_transpose2d_int8``. ``mesh``: as ``conv2d``'s."""
    if isinstance(weight, nn.Module):
        if not weight.weight.is_floating_point():
            from .quant import conv_transpose2d_int8
            return conv_transpose2d_int8(weight, x, stride,
                                         out_dtype=policy.compute_dtype)
        weight, bias = weight.weight, weight.bias
    tp = shard_mesh(weight, mesh)
    w = policy.cast_param(weight)
    x = policy.cast_input(x)
    if tp is not None:
        x = copy_to_model(x, tp)
    with policy.precision():
        y = _backward_in_fp32(F.conv_transpose2d(_to_nchw(x), w, None, stride),
                              policy)
    y = _to_nhwc(y)
    if tp is not None:
        y = gather_from_model(y, tp)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


# ---------------------------------------------------------------------------
# MaxPool2d
# ---------------------------------------------------------------------------

def max_pool2d(x: torch.Tensor, window: int = 2,
               stride: Optional[int] = None, padding: int = 0
               ) -> torch.Tensor:
    """NHWC max pool; ``padding`` pads each side with -inf (torch's
    ``MaxPool2d(3, 2, padding=1)`` of the resnet stem)."""
    stride = stride or window
    return _to_nhwc(F.max_pool2d(_to_nchw(x), window, stride, padding))


# ---------------------------------------------------------------------------
# BatchNorm2d (torch semantics: momentum 0.1, eps 1e-5, biased batch var for
# the normalization, unbiased var for the running estimate)
# ---------------------------------------------------------------------------

def _running_stats(bn: nn.BatchNorm2d, mean: torch.Tensor,
                   var: torch.Tensor, n: int, momentum: float):
    """The new running (mean, var) from a batch's biased statistics. They
    are detached: the running statistics take no gradient (the JAX step
    returns them as auxiliary outputs), and a graph kept in them would
    keep every step's activations alive once they are committed."""
    unbiased = var.detach() * (n / max(n - 1, 1))
    return ((1 - momentum) * bn.running_mean + momentum * mean.detach(),
            (1 - momentum) * bn.running_var + momentum * unbiased)


def batchnorm_from_sums(bn: nn.BatchNorm2d, total: Optional[torch.Tensor],
                        total_sq: Optional[torch.Tensor], n: int,
                        train: bool, momentum: float = 0.1,
                        eps: float = 1e-5, mesh=None):
    """BN affine (inv, shift) and the new running stats from per-channel
    f32 sums, for when the reduction was fused elsewhere (the fused conv
    kernel's epilogue). Returns (inv, shift, (mean, var)); in eval mode the
    sums are not read and may be None.

    ``mesh`` (``parallel.Mesh``): the sums are this rank's rows of a
    data-parallel batch; in train mode they are summed over the ranks (and
    n with them: every rank holds as many rows), so the statistics and
    their gradients are the global batch's, as under the JAX package's
    ``jit`` with a 'data'-sharded batch."""
    if train:
        if mesh is not None and mesh.distributed:
            both = global_sum(torch.stack([total, total_sq]), mesh)
            total, total_sq, n = both[0], both[1], n * mesh.data
        mean = total / n
        mean_sq = total_sq / n
        var = torch.clamp_min(mean_sq - mean * mean, 0.0)
        new_stats = _running_stats(bn, mean, var, n, momentum)
    else:
        mean, var = bn.running_mean, bn.running_var
        new_stats = (mean, var)
    inv = torch.rsqrt(var + eps) * bn.weight
    shift = bn.bias - mean * inv
    return inv, shift, new_stats


def batchnorm(bn: nn.BatchNorm2d, x: torch.Tensor, train: bool,
              momentum: float = 0.1, eps: float = 1e-5, mesh=None):
    """x: NHWC. Returns (y, (mean, var)). Statistics in f32 (the square in
    x's dtype, as ``lax.square`` in the JAX package); the normalization
    runs in x's dtype. ``mesh``: in train mode the statistics are the
    global batch's, the ranks' means averaged (every rank holds as many
    rows), as ``batchnorm_from_sums`` does."""
    if train:
        mean = x.float().mean(dim=(0, 1, 2))
        mean_sq = (x * x).float().mean(dim=(0, 1, 2))
        n = x.shape[0] * x.shape[1] * x.shape[2]
        if mesh is not None and mesh.distributed:
            both = global_sum(torch.stack([mean, mean_sq]), mesh) / mesh.data
            mean, mean_sq, n = both[0], both[1], n * mesh.data
        var = torch.clamp_min(mean_sq - mean * mean, 0.0)
        new_stats = _running_stats(bn, mean, var, n, momentum)
    else:
        mean, var = bn.running_mean, bn.running_var
        new_stats = (mean, var)
    inv = torch.rsqrt(var + eps) * bn.weight
    shift = bn.bias - mean * inv
    y = x * inv.to(x.dtype) + shift.to(x.dtype)
    return y, new_stats
