"""Post-training int8 quantization for inference (counterpart of
unet_convlstm_tpu/ops/quant.py).

Scheme (symmetric PTQ, as the JAX package):

* **Weights**: per-output-channel symmetric int8, ``w_q = clip(round(w /
  s), ±127)`` (round half to even) with ``s = max|w| / 127`` over every
  axis but the output channel, and ``s = 1`` where the channel is all
  zero. Quantized once by :func:`quantize_model`.
* **Activations**: *dynamic* (default) — a per-tensor scale ``max|x| /
  127`` computed on the card at each conv; or *calibrated static*
  (:func:`calibrate_tree`) — a per-site scale ``x_s`` measured once over
  calibration batches. Both quantize as ``clip(round(x / scale), ±127)``
  in f32, in that order. On the card the int8 kernel (K8's quantizing
  entry, ``ops/kernels/conv_int8.conv_int8_quant``) does it in its
  prologue, from the float activation and the scale on the card (for the
  dynamic scale after one max|x| reduction), so no int8 activation reaches
  device memory; on the CPU it stays plain torch ops.
* **Accumulation**: int32 in the hand-written kernel
  (``ops/kernels/conv_int8.py``, K8), then ``float(acc) * (x_s * w_s) +
  b`` in f32 and the policy's compute dtype.

:func:`quantize_model` returns a NEW model in which every ``Conv2d`` is a
:class:`QuantConv2d` and every ``ConvTranspose2d`` a
:class:`QuantConvTranspose2d` (int8 ``weight`` in the float module's
layout, f32 ``w_s``, ``bias``, optional ``x_s``, and a ``site`` id); BN and
every other parameter stay f32. ``ops.conv.conv2d`` and
``conv_transpose2d`` route a module with int8 weights here, so model code
is the same for float and int8 inference; a quantized ConvLSTM cell runs
the concatenated [x, h] gate conv (no hoisted input projection) and its
gate update on K1; a quantized DoubleConv does not take K2.

Site ids follow the modules' definition order (``named_modules``), which
is the order in which the JAX ``quantize_tree`` walks the same model's
parameter tree, so a site here and a ``SiteTag`` there name the same conv.

Calibration records each site's max |x| in the conv path itself, in the
order the forward runs the convs, under a lock (:func:`act_calibration`):
no unordered callbacks. A calibration forward runs each conv in f32 with
the dequantized weights, as the JAX package does. Inference only: no
gradient is defined.
"""

from __future__ import annotations

import contextlib
import copy
import threading
from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.dtypes import full_fp32
from .kernels.conv_int8 import (INT8_MAX, _const, conv_int8_quant,
                                conv_transpose_int8_quant,
                                quantize_act)  # noqa: F401 (re-exported)

# site id -> running max |x| (an f32 tensor on the activation's device),
# set only inside act_calibration(); read and written under _CALIB_LOCK
_CALIB: Optional[Dict[int, torch.Tensor]] = None
_CALIB_LOCK = threading.Lock()


class QuantConv2d(nn.Module):
    """An int8 conv: ``weight`` int8 [out, in, k, k] (channels-last memory,
    i.e. OHWI, what K8 reads), ``w_s`` f32 [out], ``bias`` f32 [out] or
    None, ``x_s`` f32 scalar or None (dynamic), and its ``site`` id."""

    weight_format = torch.channels_last

    def __init__(self, weight: torch.Tensor, w_s: torch.Tensor,
                 bias: Optional[torch.Tensor], site: int,
                 x_s: Optional[torch.Tensor] = None):
        super().__init__()
        self.register_buffer("weight", weight.contiguous(
            memory_format=self.weight_format))
        self.register_buffer("w_s", w_s)
        self.register_buffer("bias", bias)
        self.register_buffer("x_s", x_s)
        self.site = site


class QuantConvTranspose2d(QuantConv2d):
    """An int8 transposed conv: ``weight`` int8 [in, out, k, k] (torch's
    layout), ``w_s`` f32 [out] (axis 2 of the JAX package's HWOI kernel),
    ``bias``, ``x_s`` and ``site`` as :class:`QuantConv2d`."""

    weight_format = torch.contiguous_format


QUANT_MODULES = (QuantConv2d, QuantConvTranspose2d)


# ---------------------------------------------------------------------------
# Calibration context
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def act_calibration():
    """Collect per-site activation ranges from every dynamic quantized conv
    that runs inside this block (on any thread). Yields a dict that holds
    site id → max |x| (a float) once the block exits; pass it to
    :func:`attach_act_scales`. Contexts do not nest."""
    global _CALIB
    with _CALIB_LOCK:
        if _CALIB is not None:
            raise RuntimeError("act_calibration() contexts do not nest")
        _CALIB = {}
    ranges: Dict[int, float] = {}
    try:
        yield ranges
    finally:
        with _CALIB_LOCK:
            recorded, _CALIB = _CALIB, None
        # one host copy of every site's max, in the order the sites ran
        ranges.update({sid: float(v) for sid, v in recorded.items()})


def _calibrating() -> bool:
    with _CALIB_LOCK:
        return _CALIB is not None


def _record_amax(site: int, x: torch.Tensor) -> None:
    amax = x.detach().abs().amax().float()
    with _CALIB_LOCK:
        if _CALIB is None:
            return
        prev = _CALIB.get(site)
        _CALIB[site] = amax if prev is None else torch.maximum(prev, amax)


# ---------------------------------------------------------------------------
# Weights (the activation quantizer, ``quantize_act`` and the static
# ``quantize_with``, is the plain version of K8's prologue and lives beside
# the kernel, in ops/kernels/conv_int8.py)
# ---------------------------------------------------------------------------

def quantize_weight(w: torch.Tensor, out_axis: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8: (w_q int8, scale f32 [O])."""
    w = w.detach().float()
    reduce = tuple(a for a in range(w.dim()) if a != out_axis)
    amax = w.abs().amax(dim=reduce)
    scale = torch.where(amax > 0, amax / _const(INT8_MAX, w),
                        torch.ones_like(amax))
    shape = [1] * w.dim()
    shape[out_axis] = -1
    w_q = torch.clamp(torch.round(w / scale.reshape(shape)),
                      -INT8_MAX, INT8_MAX).to(torch.int8)
    return w_q, scale


# ---------------------------------------------------------------------------
# The int8 convolutions
# ---------------------------------------------------------------------------

def conv2d_int8(m: QuantConv2d, x: torch.Tensor, stride: int = 1,
                pads=((0, 0), (0, 0)),
                out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """int8 NHWC conv of a :class:`QuantConv2d` with explicit pads
    ((top, bottom), (left, right)): the calibrated static activation scale
    where the site has one, else the dynamic one; int32 accumulation (K8 on
    the card, which quantizes x in its prologue), per-channel dequant,
    bias."""
    if m.w_s.shape[0] != m.weight.shape[0]:
        raise ValueError(
            f"w_s has {m.w_s.shape[0]} scales but the kernel has "
            f"{m.weight.shape[0]} output channels — was a transposed "
            "kernel quantized as a regular conv? Transposed kernels must be "
            "QuantConvTranspose2d, scaled on their output axis (1 in "
            "torch's [in, out, k, k] layout)")
    if m.x_s is None and _calibrating():
        # calibration pass: record the input range, then the conv in f32
        # with dequantized weights (textbook PTQ observes the float model)
        _record_amax(m.site, x)
        w = m.weight.float() * m.w_s.reshape(-1, 1, 1, 1)
        (pt, pb), (pl, pr) = pads
        xt = F.pad(x.float().permute(0, 3, 1, 2), (pl, pr, pt, pb))
        with full_fp32():
            y = F.conv2d(xt, w, None, stride).permute(0, 2, 3, 1)
        if m.bias is not None:
            y = y + m.bias
        return y.to(out_dtype)
    return conv_int8_quant(x, m.weight, m.w_s, m.x_s, m.bias, stride, pads,
                           out_dtype)


def conv_transpose2d_int8(m: QuantConvTranspose2d, x: torch.Tensor,
                          stride: int = 2,
                          out_dtype: torch.dtype = torch.float32
                          ) -> torch.Tensor:
    """int8 NHWC transposed conv (VALID) of a
    :class:`QuantConvTranspose2d`."""
    if m.w_s.shape[0] != m.weight.shape[1]:
        raise ValueError(
            f"w_s has {m.w_s.shape[0]} scales but the transposed kernel has "
            f"{m.weight.shape[1]} output channels — quantize transposed "
            "kernels on their output axis (quantize_model does)")
    if m.x_s is None and _calibrating():
        _record_amax(m.site, x)
        w = m.weight.float() * m.w_s.reshape(1, -1, 1, 1)
        with full_fp32():
            y = F.conv_transpose2d(x.float().permute(0, 3, 1, 2), w, None,
                                   stride).permute(0, 2, 3, 1)
        if m.bias is not None:
            y = y + m.bias
        return y.to(out_dtype)
    return conv_transpose_int8_quant(x, m.weight, m.w_s, m.x_s, m.bias,
                                     stride, out_dtype)


# ---------------------------------------------------------------------------
# Whole models
# ---------------------------------------------------------------------------

def _conv_sites(model: nn.Module):
    """(parent, attribute, conv) of every float Conv2d and ConvTranspose2d,
    in definition order: the site order."""
    from .conv import Conv2d, ConvTranspose2d

    named = dict(model.named_modules())
    out = []
    for name, mod in model.named_modules():
        if isinstance(mod, (Conv2d, ConvTranspose2d)):
            parent, _, attr = name.rpartition(".")
            out.append((named[parent], attr, mod))
    return out


def quantize_model(model: nn.Module) -> nn.Module:
    """A NEW model with every conv int8-quantized (the counterpart of
    ``quantize_tree``); ``model`` is left untouched. Each conv gets the
    next site id in definition order. A tensor-parallel model's shards
    are refused: quantize the whole model."""
    from ..parallel.tensor import model_axis
    from .conv import ConvTranspose2d

    if any(model_axis(p) is not None for p in model.parameters()):
        raise ValueError("quantize_model takes a whole model, not a "
                         "tensor-parallel shard of one (gather it with "
                         "parallel.full_state_dict)")
    q = copy.deepcopy(model)
    for site, (parent, attr, conv) in enumerate(_conv_sites(q)):
        bias = None if conv.bias is None else conv.bias.detach().float()
        if isinstance(conv, ConvTranspose2d):
            w_q, w_s = quantize_weight(conv.weight, 1)
            new = QuantConvTranspose2d(w_q, w_s, bias, site)
        else:
            w_q, w_s = quantize_weight(conv.weight, 0)
            new = QuantConv2d(w_q, w_s, bias, site)
        setattr(parent, attr, new)
    return q


def quant_sites(model: nn.Module) -> Dict[int, nn.Module]:
    """site id → quantized conv module of a quantized model."""
    return {m.site: m for m in model.modules() if isinstance(m, QUANT_MODULES)}


def load_quantized_state_dict(qmodel: nn.Module,
                              state: Dict[str, torch.Tensor]) -> None:
    """Load a quantized state dict (each site's int8 ``weight``, ``w_s``,
    ``bias`` and, where calibrated, ``x_s``; e.g. a JAX ``quantize_tree``
    carried by ``utils.torch_weights.state_dict_from_jax``) into a model
    from :func:`quantize_model` of the same architecture, strictly."""
    for name, m in qmodel.named_modules():
        if isinstance(m, QUANT_MODULES):
            x_s = state.get(f"{name}.x_s")
            m.x_s = (None if x_s is None else
                     x_s.to(device=m.w_s.device, dtype=torch.float32))
    qmodel.load_state_dict(state, strict=True)


def attach_act_scales(qmodel: nn.Module, ranges: Dict[int, float]
                      ) -> nn.Module:
    """A NEW model whose sites with a positive recorded range carry the
    static scale ``x_s = amax / 127``; sites never run during calibration,
    and sites with amax 0 (an all-zero activation), stay dynamic."""
    out = copy.deepcopy(qmodel)
    for sid, m in quant_sites(out).items():
        amax = ranges.get(sid, 0.0)
        if amax > 0.0:
            m.x_s = torch.tensor(np.float32(amax / INT8_MAX),
                                 device=m.w_s.device)
    return out


def calibrate_tree(apply_fn: Callable, qmodel: nn.Module,
                   batches: Iterable, **apply_kw) -> nn.Module:
    """Static-activation calibration: ``apply_fn(qmodel, x, train=False,
    **apply_kw)`` over the calibration ``batches`` (an iterable of [B, T,
    H, W, C] arrays or tensors, already normalized) inside an
    :func:`act_calibration` block, on the model's device; returns a new
    model with the per-site ``x_s`` attached."""
    dev = next(iter(qmodel.buffers())).device
    with act_calibration() as ranges, torch.inference_mode():
        out = None
        for xb in batches:
            x = torch.as_tensor(np.asarray(xb, np.float32) if not isinstance(
                xb, torch.Tensor) else xb).to(dev)
            out, _, _ = apply_fn(qmodel, x, train=False, **apply_kw)
        if out is None:
            raise ValueError("calibrate_tree: no calibration batches given")
    return attach_act_scales(qmodel, ranges)
