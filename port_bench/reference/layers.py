"""The layers the plain references are built from: NCHW, float32, no
kernels, no cache, no batching tricks.

BatchNorm is functional: a train-mode forward returns the new running
statistics (momentum 0.1, unbiased variance for the estimate) instead of
writing them, so the caller commits them after the optimizer step.

``quant`` (optional): a function applied to every convolution's input and
weight before it runs, the control that computes in a lower precision.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]
Quant = Optional[Callable[[torch.Tensor], torch.Tensor]]


# ---------------------------------------------------------------------------
# Parameter lists: (name, shape, kind). Kinds: "w" a conv weight (uniform,
# bound 1/sqrt(shape[1]*k*k)), "b" the bias of the weight named before it,
# "bn_w", "bn_b", "bn_mean", "bn_var", "bn_count".
# ---------------------------------------------------------------------------

def conv_specs(specs, name, cout, cin, k, bias=True):
    specs.append((f"{name}.weight", (cout, cin, k, k), "w"))
    if bias:
        specs.append((f"{name}.bias", (cout,), "b"))


def conv_t_specs(specs, name, cin, cout, k=2):
    specs.append((f"{name}.weight", (cin, cout, k, k), "w"))
    specs.append((f"{name}.bias", (cout,), "b"))


def bn_specs(specs, name, c):
    for suffix, kind in (("weight", "bn_w"), ("bias", "bn_b"),
                         ("running_mean", "bn_mean"),
                         ("running_var", "bn_var"),
                         ("num_batches_tracked", "bn_count")):
        specs.append((f"{name}.{suffix}", () if kind == "bn_count" else (c,),
                      kind))


def double_conv_specs(specs, pre, cin, cout):
    conv_specs(specs, f"{pre}.0", cout, cin, 3)
    bn_specs(specs, f"{pre}.1", cout)
    conv_specs(specs, f"{pre}.3", cout, cout, 3)
    bn_specs(specs, f"{pre}.4", cout)


def lstm_specs(specs, pre, cin, hidden, layers):
    for l in range(layers):
        conv_specs(specs, f"{pre}.layers.{l}.conv", 4 * hidden,
                   (cin if l == 0 else hidden) + hidden, 3)


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

def conv(x, w, b=None, stride=1, padding=1, quant: Quant = None):
    if quant is not None:
        x, w = quant(x), quant(w)
    return F.conv2d(x, w, b, stride, padding)


def conv_t(x, w, b, quant: Quant = None):
    """The 2x2, stride 2 transposed convolution."""
    if quant is not None:
        x, w = quant(x), quant(w)
    return F.conv_transpose2d(x, w, b, stride=2)


def bn(P: Params, pre: str, x, train: bool, new: Dict[str, torch.Tensor],
       momentum: float = 0.1, eps: float = 1e-5):
    """BatchNorm2d; in train mode the batch statistics, the new running
    ones written into ``new``."""
    w, b = P[f"{pre}.weight"], P[f"{pre}.bias"]
    if train:
        mean = x.mean(dim=(0, 2, 3))
        var = x.var(dim=(0, 2, 3), unbiased=False)
        n = x.numel() // x.shape[1]
        new[f"{pre}.running_mean"] = ((1 - momentum) * P[f"{pre}.running_mean"]
                                      + momentum * mean.detach())
        new[f"{pre}.running_var"] = ((1 - momentum) * P[f"{pre}.running_var"]
                                     + momentum * var.detach() * n / (n - 1))
    else:
        mean, var = P[f"{pre}.running_mean"], P[f"{pre}.running_var"]
    inv = torch.rsqrt(var + eps) * w
    return x * inv[None, :, None, None] + (b - mean * inv)[None, :, None, None]


def double_conv(P, pre, x, train, new, quant, momentum=0.1):
    x = conv(x, P[f"{pre}.0.weight"], P[f"{pre}.0.bias"], quant=quant)
    x = torch.relu(bn(P, f"{pre}.1", x, train, new, momentum))
    x = conv(x, P[f"{pre}.3.weight"], P[f"{pre}.3.bias"], quant=quant)
    return torch.relu(bn(P, f"{pre}.4", x, train, new, momentum))


def convlstm(P, pre, xs: List[torch.Tensor], layers: int,
             state: Optional[list], quant: Quant):
    """A ConvLSTM stack over a list of T frames [B, C, h, w]; gates i, f,
    g, o from one 3x3 conv over concat(x, h). Returns the top layer's
    outputs and each layer's final (h, c)."""
    new_state = []
    for l in range(layers):
        w, b = P[f"{pre}.layers.{l}.conv.weight"], P[f"{pre}.layers.{l}.conv.bias"]
        hidden = w.shape[0] // 4
        if state is None:
            z = xs[0].new_zeros((xs[0].shape[0], hidden) + xs[0].shape[2:])
            h, c = z, z
        else:
            h, c = state[l]
        outs = []
        for x in xs:
            gates = conv(torch.cat([x, h], dim=1), w, b, quant=quant)
            i, f, g, o = torch.split(gates, hidden, dim=1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            outs.append(h)
        xs = outs
        new_state.append((h, c))
    return xs, new_state


def frames(x_seq):
    """[B, T, C, H, W] → [T*B, C, H, W], time-major rows."""
    B, T = x_seq.shape[:2]
    return x_seq.transpose(0, 1).reshape(T * B, *x_seq.shape[2:])


def times(x_bt, B, T):
    return list(x_bt.reshape(T, B, *x_bt.shape[1:]).unbind(0))


def unframes(y_bt, B, T):
    return y_bt.reshape(T, B, *y_bt.shape[1:]).transpose(0, 1)
