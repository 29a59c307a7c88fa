"""The ``resnet18`` model family: the PretrainedTemporalUNet of
https://github.com/dordanino12/unet-convlstm (``train/resnet18.py``, the
model that ``main.py:213`` builds with USE_PRETRAINED=True), as a plain
float32 reference and as the shapes the yardstick counts. The functions
are those ``reference/custom.py`` lists.

The model, frame by frame except for the recurrences:

* encoder: torchvision's ResNet18 (He et al. 2016) with ``in_channels``
  input channels and no pooling head, as segmentation-models-pytorch
  wraps it; features at /2 (the stem's ReLU, 64 channels), /4, /8, /16
  and /32 (the four stages, 64, 128, 256 and 512 channels);
* a ConvLSTM stack of ``lstm_layers`` layers over the /32 feature's
  sequence (``lstm``) and one over each of the four other features'
  (``lstm_skips.1`` to ``lstm_skips.4``), hidden width that of its input,
  gates i, f, g, o from one 3x3 conv over concat(x, h);
* segmentation-models-pytorch's ``Unet`` decoder: five blocks of nearest
  2x upsampling, concatenation with the skip (none in the last), and two
  3x3 conv + BatchNorm + ReLU, 256, 128, 64, 32 and 16 wide; a 3x3 head.

Departures from the published model:

* ``lstm_skips.0``: the published model also builds a ConvLSTM stack over
  the encoder's identity stage (the input frames, ``in_channels`` wide),
  whose output its decoder drops. Its parameters are in ``specs``, so the
  seeded state dict is the published one whole (the port, which has no
  such module, drops those keys as it loads); ``forward`` does not run
  it, since nothing it computes reaches the output or the carried state.
* The decoder's convs carry no bias in the published model (a conv ahead
  of BatchNorm); the port holds one. ``specs`` lists each as kind
  ``zero``: the seeded state dict sets it to 0, so that the port loads
  with ``strict=True`` and both compute the published model.
* The encoder's weights are drawn from the seed, not ImageNet's (the
  configuration's ``assumed``).
* ``forward(train=True)`` runs every BatchNorm, the frozen encoder's
  included, on its batch's statistics, as the published model's
  ``model.train()`` does (the port does so with ``encoder_bn_train``; its
  default keeps a frozen encoder's BatchNorm in inference mode). Only
  ``calibrate_bn`` trains this family here: no cell trains it.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from .. import roofline
from . import layers as L
from .train import no_tf32

ENCODER_CHANNELS = (64, 64, 128, 256, 512)      # features at /2 .. /32
DECODER_CHANNELS = (256, 128, 64, 32, 16)
STAGES = ((64, 64, 1), (64, 128, 2), (128, 256, 2), (256, 512, 2))


def _frozen(m: dict) -> bool:
    return m.get("freeze_encoder", True)


def _conv_bn_specs(out, conv, bn, cin, cout, k):
    L.conv_specs(out, conv, cout, cin, k, bias=False)
    L.bn_specs(out, bn, cout)


def specs(m: dict) -> List[Tuple[str, tuple, str]]:
    cin = m.get("in_channels", 2)
    layers = m["lstm_layers"]
    out: list = []
    _conv_bn_specs(out, "encoder.conv1", "encoder.bn1", cin, 64, 7)
    for li, (a, b, stride) in enumerate(STAGES, start=1):
        for bi in range(2):
            pre = f"encoder.layer{li}.{bi}"
            c1 = a if bi == 0 else b
            _conv_bn_specs(out, f"{pre}.conv1", f"{pre}.bn1", c1, b, 3)
            _conv_bn_specs(out, f"{pre}.conv2", f"{pre}.bn2", b, b, 3)
            if bi == 0 and (stride != 1 or a != b):
                _conv_bn_specs(out, f"{pre}.downsample.0",
                               f"{pre}.downsample.1", a, b, 1)
    in_chs = (ENCODER_CHANNELS[-1],) + DECODER_CHANNELS[:-1]
    skip_chs = tuple(reversed(ENCODER_CHANNELS[:-1])) + (0,)
    for i, (a, s, b) in enumerate(zip(in_chs, skip_chs, DECODER_CHANNELS)):
        for j, c in ((1, a + s), (2, b)):
            pre = f"decoder.blocks.{i}.conv{j}"
            L.conv_specs(out, f"{pre}.0", b, c, 3, bias=False)
            out.append((f"{pre}.0.bias", (b,), "zero"))
            L.bn_specs(out, f"{pre}.1", b)
    L.conv_specs(out, "segmentation_head.0", m.get("out_channels", 1),
                 DECODER_CHANNELS[-1], 3)
    L.lstm_specs(out, "lstm", 512, 512, layers)
    for i, ch in enumerate((cin,) + ENCODER_CHANNELS[:-1]):
        L.lstm_specs(out, f"lstm_skips.{i}", ch, ch, layers)
    return out


def trainable(m: dict, name: str) -> bool:
    """The frozen encoder does not train, nor do the decoder's conv
    biases (kind ``zero``), which the published model does not have."""
    if name.startswith("decoder.blocks.") and name.endswith(".0.bias"):
        return False
    return not (_frozen(m) and name.startswith("encoder."))


def _bn_relu(P, pre, x, train, new, momentum, relu=True):
    y = L.bn(P, pre, x, train, new, momentum)
    return torch.relu(y) if relu else y


def _encoder(P, x, train, new, quant, momentum):
    """x [N, C, H, W] → the five features, /2 to /32."""
    y = L.conv(x, P["encoder.conv1.weight"], None, stride=2, padding=3,
               quant=quant)
    f1 = _bn_relu(P, "encoder.bn1", y, train, new, momentum)
    y = F.max_pool2d(f1, 3, 2, padding=1)
    feats = [f1]
    for li, (_, _, stride) in enumerate(STAGES, start=1):
        for bi in range(2):
            pre = f"encoder.layer{li}.{bi}"
            s = stride if bi == 0 else 1
            r = L.conv(y, P[f"{pre}.conv1.weight"], None, stride=s,
                       quant=quant)
            r = _bn_relu(P, f"{pre}.bn1", r, train, new, momentum)
            r = L.conv(r, P[f"{pre}.conv2.weight"], None, quant=quant)
            r = _bn_relu(P, f"{pre}.bn2", r, train, new, momentum, False)
            if f"{pre}.downsample.0.weight" in P:
                y = L.conv(y, P[f"{pre}.downsample.0.weight"], None,
                           stride=s, padding=0, quant=quant)
                y = _bn_relu(P, f"{pre}.downsample.1", y, train, new,
                             momentum, False)
            y = torch.relu(r + y)
        feats.append(y)
    return feats


def _decoder(P, feats, train, new, quant, momentum):
    skips = feats[:-1][::-1]                     # /16, /8, /4, /2
    y = feats[-1]
    for i in range(len(DECODER_CHANNELS)):
        y = F.interpolate(y, scale_factor=2, mode="nearest")
        if i < len(skips):
            y = torch.cat([y, skips[i]], dim=1)
        for j in (1, 2):
            pre = f"decoder.blocks.{i}.conv{j}"
            y = L.conv(y, P[f"{pre}.0.weight"], P[f"{pre}.0.bias"],
                       quant=quant)
            y = _bn_relu(P, f"{pre}.1", y, train, new, momentum)
    return L.conv(y, P["segmentation_head.0.weight"],
                  P["segmentation_head.0.bias"], quant=quant)


def forward(P: L.Params, m: dict, x_seq, state=None, train=False,
            quant: L.Quant = None, momentum: float = 0.1):
    """x_seq [B, T, C, H, W] float32, with TF32 off throughout."""
    B, T = x_seq.shape[:2]
    new: Dict[str, torch.Tensor] = {}
    state = state or {}
    out_state = {}
    with no_tf32():
        feats = _encoder(P, L.frames(x_seq), train, new, quant, momentum)
        stacks = [("temporal", "lstm", 4)] + [
            (f"skip{i}", f"lstm_skips.{i + 1}", i) for i in range(4)]
        for key, pre, i in stacks:
            hs, out_state[key] = L.convlstm(P, pre, L.times(feats[i], B, T),
                                            m["lstm_layers"],
                                            state.get(key), quant)
            feats[i] = torch.cat(hs)
        y = _decoder(P, feats, train, new, quant, momentum)
    return L.unframes(y, B, T), out_state, new


# ---------------------------------------------------------------------------
# The shapes the yardstick counts (port_bench/roofline.py)
# ---------------------------------------------------------------------------

def _levels(H: int, W: int):
    """(h, w, channels) of the five encoder features."""
    return [(H >> (i + 1), W >> (i + 1), c)
            for i, c in enumerate(ENCODER_CHANNELS)]


def lstm_cells(m: dict, H: int, W: int) -> List[Tuple[int, int, int]]:
    """The bottleneck's stack, then the four skips', each ``lstm_layers``
    deep (``lstm_skips.0`` does not run)."""
    lv = _levels(H, W)
    return [c for c in [lv[4]] + lv[:4] for _ in range(m["lstm_layers"])]


def k2_convs(m: dict, H: int, W: int) -> list:
    """None: the family's decoder never runs on the fused conv."""
    return []


def convs(m: dict, B: int, T: int, H: int, W: int) -> List[roofline.Conv]:
    c = roofline.conv
    N = B * T
    cin = m.get("in_channels", 2)
    trains = not _frozen(m)
    lv = _levels(H, W)
    # the encoder: no weight gradient when frozen, and never an input
    # gradient into the frames; its stages' first convs take one where
    # the encoder trains
    out = [c(N, H // 2, W // 2, cin, 64, 7, dw=trains, dx=False)]
    for li, (a, b, stride) in enumerate(STAGES, start=1):
        h, w, _ = lv[li]
        for bi in range(2):
            c1 = a if bi == 0 else b
            out += [c(N, h, w, c1, b, 3, dw=trains, dx=trains),
                    c(N, h, w, b, b, 3, dw=trains, dx=trains)]
            if bi == 0 and (stride != 1 or a != b):
                out.append(c(N, h, w, a, b, 1, dw=trains, dx=trains))
    # the ConvLSTM stacks: the first layer's input is an encoder feature,
    # which takes a gradient only where the encoder trains
    for h, w, ch in [lv[4]] + lv[:4]:
        for layer in range(m["lstm_layers"]):
            out += roofline.gate_convs(B, T, h, w, ch, ch,
                                       x_grad=layer > 0 or trains)
    in_chs = (ENCODER_CHANNELS[-1],) + DECODER_CHANNELS[:-1]
    skip_chs = tuple(reversed(ENCODER_CHANNELS[:-1])) + (0,)
    for i, (a, s, b) in enumerate(zip(in_chs, skip_chs, DECODER_CHANNELS)):
        h, w = H >> (4 - i), W >> (4 - i)
        out += [c(N, h, w, a + s, b, 3), c(N, h, w, b, b, 3)]
    out.append(c(N, H, W, DECODER_CHANNELS[-1], m.get("out_channels", 1), 3))
    return out
