"""UNet building blocks, NHWC (counterpart of unet_convlstm_tpu/ops/blocks.py).

* DoubleConv       — Conv3x3+BN+ReLU twice (``net.0``, ``net.1``, ``net.3``,
                     ``net.4``: the reference's module names)
* Down             — MaxPool2 then DoubleConv (``net.1``)
* Up               — ConvTranspose(k2, s2) + center-pad-to-match +
                     concat(skip, up) + DoubleConv (``up``, ``conv``)
* OutConv          — 1x1 conv (``conv``)
* SpatialAttention — [mean_c ‖ max_c] → 7x7 conv → sigmoid gate (``conv``)

Each block is an ``nn.Module`` that holds the parameters and a function
that applies it; BatchNorm running statistics are returned, not written
back, as the JAX package threads them.

``fused=True`` runs a DoubleConv through the fused 3x3 conv kernel
(ops/kernels/doubleconv_fused.py), as the JAX flag runs the Pallas one.
The convs are passed to ``ops.conv`` as modules, so a model quantized by
``ops/quant.quantize_model`` runs the same code on its int8 modules.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..core.dtypes import DEFAULT_POLICY, Policy
from .conv import (Conv2d, ConvTranspose2d, batchnorm, batchnorm_from_sums,
                   conv2d, conv_transpose2d, max_pool2d)
from .kernels.doubleconv_fused import fused_conv3x3, kernel_supports

BNStats = Tuple[torch.Tensor, torch.Tensor]   # (running mean, running var)


# ---------------------------------------------------------------------------
# DoubleConv
# ---------------------------------------------------------------------------

class DoubleConv(nn.Module):
    def __init__(self, in_ch: int, out_ch: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.net = nn.Sequential(
            Conv2d(in_ch, out_ch, 3, generator=generator),
            nn.BatchNorm2d(out_ch), nn.ReLU(),
            Conv2d(out_ch, out_ch, 3, generator=generator),
            nn.BatchNorm2d(out_ch), nn.ReLU())

    conv1 = property(lambda self: self.net[0])
    bn1 = property(lambda self: self.net[1])
    conv2 = property(lambda self: self.net[3])
    bn2 = property(lambda self: self.net[4])


def double_conv(m: DoubleConv, x: torch.Tensor, train: bool,
                policy: Policy = DEFAULT_POLICY, fused: bool = False,
                mesh=None) -> Tuple[torch.Tensor, Dict[str, BNStats]]:
    """x [N, H, W, Cin] → (y [N, H, W, Cout], {"bn1", "bn2"} stats).
    ``mesh``: train-mode BatchNorm over the data-parallel global batch."""
    if fused and m.conv1.weight.is_floating_point():
        # integer (int8) weights take the unfused path, as in the JAX
        # package. conv2 (c1 -> c2, with the BN1 prologue) must be at least
        # 16 channels wide; conv1 is fused only for cin >= 16 (the
        # 2-channel network input stays a library conv). The JAX VMEM guard
        # has no counterpart here: the kernel's own shape guard decides.
        x_c = policy.cast_input(x)
        cin = x_c.shape[-1]
        c1, c2 = m.conv1.weight.shape[0], m.conv2.weight.shape[0]
        if min(c1, c2) >= 16 and kernel_supports(c1, c2, x_c.dtype):
            conv1_fused = cin >= 16 and kernel_supports(cin, c1, x_c.dtype)
            return _double_conv_fused(m, x_c, train, policy, conv1_fused,
                                      mesh)
    y = conv2d(x, _conv_module(m.conv1), policy=policy)
    y, s1 = batchnorm(m.bn1, y, train, mesh=mesh)
    y = torch.relu(y)
    y = conv2d(y, _conv_module(m.conv2), policy=policy)
    y, s2 = batchnorm(m.bn2, y, train, mesh=mesh)
    y = torch.relu(y)
    return y, {"bn1": s1, "bn2": s2}


def _conv_module(c: nn.Module) -> nn.Module:
    """The conv of a DoubleConv's ``conv1``/``conv2``: the module itself,
    or item 0 of the ResNet decoder's Conv2dReLU (conv, BN, ReLU)."""
    return c[0] if isinstance(c, nn.Sequential) else c


def _double_conv_fused(m: DoubleConv, x_c: torch.Tensor, train: bool,
                       policy: Policy, conv1_fused: bool, mesh=None):
    """conv1 reduces the BN1 sums in its epilogue; conv2 applies BN1's
    normalize+ReLU as its prologue and reduces the BN2 sums; only the final
    normalize+ReLU runs outside the kernel, in the compute dtype. In eval
    mode the sums are not read and BN1's running-stat affine is the
    prologue."""
    n_pix = x_c.shape[0] * x_c.shape[1] * x_c.shape[2]
    if conv1_fused:
        y1, s1, q1 = fused_conv3x3(x_c, policy.cast_param(m.conv1.weight),
                                   m.conv1.bias)
    else:
        y1 = conv2d(x_c, _conv_module(m.conv1), policy=policy)
        s1 = q1 = None
        if train:
            y1f = y1.float()
            s1 = y1f.sum(dim=(0, 1, 2))
            q1 = (y1f * y1f).sum(dim=(0, 1, 2))
    inv1, shift1, new_s1 = batchnorm_from_sums(m.bn1, s1, q1, n_pix, train,
                                               mesh=mesh)
    y2, s2, q2 = fused_conv3x3(y1, policy.cast_param(m.conv2.weight),
                               m.conv2.bias, pre_inv=inv1, pre_shift=shift1)
    inv2, shift2, new_s2 = batchnorm_from_sums(m.bn2, s2, q2, n_pix, train,
                                               mesh=mesh)
    y = torch.relu(y2 * inv2.to(y2.dtype) + shift2.to(y2.dtype))
    return y, {"bn1": new_s1, "bn2": new_s2}


# ---------------------------------------------------------------------------
# Down: MaxPool2 + DoubleConv
# ---------------------------------------------------------------------------

class Down(nn.Module):
    def __init__(self, in_ch: int, out_ch: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.net = nn.Sequential(nn.MaxPool2d(2),
                                 DoubleConv(in_ch, out_ch, generator))


def down(m: Down, x: torch.Tensor, train: bool,
         policy: Policy = DEFAULT_POLICY, fused: bool = False, mesh=None):
    return double_conv(m.net[1], max_pool2d(x, 2), train, policy, fused,
                       mesh)


# ---------------------------------------------------------------------------
# Up: ConvTranspose2d(in, in//2, 2, s2) + pad-to-skip + concat + DoubleConv
# ---------------------------------------------------------------------------

class Up(nn.Module):
    def __init__(self, in_ch: int, out_ch: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.up = ConvTranspose2d(in_ch, in_ch // 2, 2, generator=generator)
        self.conv = DoubleConv(in_ch, out_ch, generator)


def up(m: Up, x_deep: torch.Tensor, x_skip: torch.Tensor, train: bool,
       policy: Policy = DEFAULT_POLICY, fused: bool = False, mesh=None):
    """x_deep: coarse feature to upsample; x_skip: encoder skip (NHWC)."""
    x1 = conv_transpose2d(x_deep, m.up, stride=2, policy=policy)
    # center-pad x1 to the skip: dh//2 on top, dh - dh//2 on the bottom
    dh = x_skip.shape[1] - x1.shape[1]
    dw = x_skip.shape[2] - x1.shape[2]
    if dh or dw:
        x1 = F.pad(x1, (0, 0, dw // 2, dw - dw // 2, dh // 2, dh - dh // 2))
    x = torch.cat([x_skip, x1.to(x_skip.dtype)], dim=-1)
    y, s = double_conv(m.conv, x, train, policy, fused, mesh)
    return y, {"conv": s}


# ---------------------------------------------------------------------------
# OutConv: 1x1
# ---------------------------------------------------------------------------

class OutConv(nn.Module):
    def __init__(self, in_ch: int, out_ch: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv = Conv2d(in_ch, out_ch, 1, generator=generator)


def out_conv(m: OutConv, x: torch.Tensor, policy: Policy = DEFAULT_POLICY):
    return conv2d(x, m.conv, policy=policy)


# ---------------------------------------------------------------------------
# SpatialAttention (CBAM-style)
# ---------------------------------------------------------------------------

class SpatialAttention(nn.Module):
    def __init__(self, kernel_size: int = 7,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv = Conv2d(2, 1, kernel_size, bias=False, generator=generator)


def spatial_attention(m: SpatialAttention, x: torch.Tensor,
                      policy: Policy = DEFAULT_POLICY):
    avg = x.mean(dim=-1, keepdim=True)
    mx = x.amax(dim=-1, keepdim=True)
    gate = torch.sigmoid(conv2d(torch.cat([avg, mx], dim=-1), m.conv,
                                policy=policy))
    return x * gate.to(x.dtype)
