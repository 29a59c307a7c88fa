"""The ``custom`` model family: the TemporalUNetDualView of
https://github.com/dordanino12/unet-convlstm (``train/unet.py``, ``main.py``
CUSTOM_CFG), as a plain float32 reference and as the shapes the yardstick
counts.

A family is found by its configuration's ``model.type``
(``port_bench/reference/<type>.py``), and gives:

* ``specs(m)``: every parameter and buffer, (name, shape, kind), in the
  reference's own state-dict names, so one seeded state dict loads into
  the port (``strict=True``) and into ``forward`` alike;
* ``trainable(m, name)``: whether a parameter trains;
* ``forward(P, m, x_seq, state, train, quant, momentum)``: x_seq [B, T, C,
  H, W] → (y [B, T, out, H, W], new recurrent state, new running
  statistics);
* ``lstm_cells(m, H, W)``: (h, w, hidden) of each ConvLSTM layer a frame
  (K1's launches);
* ``k2_convs(m, H, W)``: (h, w, cin, cout, prologue) of each conv that runs
  on K2 a frame;
* ``convs(m, B, T, H, W)``: every convolution of a step, for the model
  FLOPs behind ``mfu``.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from .. import roofline
from . import layers as L


def specs(m: dict) -> List[Tuple[str, tuple, str]]:
    bc = m["base_ch"]
    cin = 2 * m.get("in_channels_per_sat", 1)
    out: list = []
    L.double_conv_specs(out, "inc.net", cin, bc)
    chans = [bc, 2 * bc, 4 * bc, 8 * bc, 16 * bc]
    for name, a, b in (("down1", 0, 1), ("down2", 1, 2), ("down3", 2, 3),
                       ("bottleneck", 3, 4)):
        L.double_conv_specs(out, f"{name}.net.1.net", chans[a], chans[b])
    L.lstm_specs(out, "temporal", 16 * bc, 16 * bc, m["lstm_layers"])
    if m["use_skip_lstm"]:
        L.lstm_specs(out, "lstm_skip3", 8 * bc, 8 * bc, 1)
        L.lstm_specs(out, "lstm_skip2", 4 * bc, 4 * bc, 1)
    for name, a, b in (("up3", 4, 3), ("up2", 3, 2), ("up1", 2, 1),
                       ("up0", 1, 0)):
        L.conv_t_specs(out, f"{name}.up", chans[a], chans[a] // 2)
        L.double_conv_specs(out, f"{name}.conv.net", chans[a], chans[b])
    L.conv_specs(out, "outc.conv", m.get("out_channels", 1), bc, 1)
    return out


def trainable(m: dict, name: str) -> bool:
    return True


def forward(P: L.Params, m: dict, x_seq, state=None, train=False,
            quant: L.Quant = None, momentum: float = 0.1):
    B, T = x_seq.shape[:2]
    new: Dict[str, torch.Tensor] = {}
    x0 = L.double_conv(P, "inc.net", L.frames(x_seq), train, new, quant,
                       momentum)
    skips = [x0]
    for name in ("down1", "down2", "down3", "bottleneck"):
        skips.append(L.double_conv(P, f"{name}.net.1.net",
                                   F.max_pool2d(skips[-1], 2), train, new,
                                   quant, momentum))
    x0, x1, x2, x3, xb = skips
    state = state or {}
    out_state = {}
    hs, out_state["temporal"] = L.convlstm(P, "temporal", L.times(xb, B, T),
                                           m["lstm_layers"],
                                           state.get("temporal"), quant)
    xb = torch.cat(hs)
    if m["use_skip_lstm"]:
        h3, out_state["skip3"] = L.convlstm(P, "lstm_skip3",
                                            L.times(x3, B, T), 1,
                                            state.get("skip3"), quant)
        h2, out_state["skip2"] = L.convlstm(P, "lstm_skip2",
                                            L.times(x2, B, T), 1,
                                            state.get("skip2"), quant)
        x3, x2 = torch.cat(h3), torch.cat(h2)
    y = xb
    for name, skip in (("up3", x3), ("up2", x2), ("up1", x1), ("up0", x0)):
        u = L.conv_t(y, P[f"{name}.up.weight"], P[f"{name}.up.bias"], quant)
        y = L.double_conv(P, f"{name}.conv.net", torch.cat([skip, u], dim=1),
                          train, new, quant, momentum)
    y = L.conv(y, P["outc.conv.weight"], P["outc.conv.bias"], padding=0,
               quant=quant)
    return L.unframes(y, B, T), out_state, new


# ---------------------------------------------------------------------------
# The shapes the yardstick counts (port_bench/roofline.py)
# ---------------------------------------------------------------------------

def _levels(m: dict, H: int, W: int):
    """(h, w, channels) of the five encoder levels."""
    bc = m["base_ch"]
    return [(H >> i, W >> i, bc << i) for i in range(5)]


def lstm_cells(m: dict, H: int, W: int) -> List[Tuple[int, int, int]]:
    lv = _levels(m, H, W)
    cells = [lv[4]] * m["lstm_layers"]
    if m["use_skip_lstm"]:
        cells += [lv[3], lv[2]]
    return cells


def k2_convs(m: dict, H: int, W: int) -> List[Tuple[int, int, int, int, bool]]:
    """The DoubleConvs' convs: conv2 always, with BN1 as its prologue;
    conv1 where its input has 16 channels or more."""
    lv = _levels(m, H, W)
    cin0 = 2 * m.get("in_channels_per_sat", 1)
    blocks = [(lv[0][0], lv[0][1], cin0, lv[0][2])]
    blocks += [(lv[i][0], lv[i][1], lv[i - 1][2], lv[i][2]) for i in range(1, 5)]
    blocks += [(lv[i][0], lv[i][1], 2 * lv[i][2], lv[i][2])
               for i in (3, 2, 1, 0)]
    convs = []
    for h, w, cin, cout in blocks:
        if cin >= 16:
            convs.append((h, w, cin, cout, False))
        convs.append((h, w, cout, cout, True))
    return convs


def convs(m: dict, B: int, T: int, H: int, W: int) -> List[roofline.Conv]:
    c = roofline.conv
    N = B * T
    lv = _levels(m, H, W)
    cin0 = 2 * m.get("in_channels_per_sat", 1)
    out = [c(N, H, W, cin0, lv[0][2], 3, dx=False),
           c(N, H, W, lv[0][2], lv[0][2], 3)]
    for i in range(1, 5):
        h, w, ch = lv[i]
        out += [c(N, h, w, lv[i - 1][2], ch, 3), c(N, h, w, ch, ch, 3)]
    for h, w, ch in lstm_cells(m, H, W):
        out += roofline.gate_convs(B, T, h, w, ch, ch, x_grad=True)
    for i in (3, 2, 1, 0):
        h, w, ch = lv[i]
        # the k2 s2 transposed conv: a 1x1's work at the output size
        out += [c(N, h, w, 2 * ch, ch, 1), c(N, h, w, 2 * ch, ch, 3),
                c(N, h, w, ch, ch, 3)]
    out.append(c(N, H, W, lv[0][2], m.get("out_channels", 1), 1))
    return out
