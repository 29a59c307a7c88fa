"""TemporalUNetDualView — dual-satellite UNet with ConvLSTM bottleneck and
skips (counterpart of unet_convlstm_tpu/models/temporal_unet.py).

* Encoder inc/down1..3/bottleneck with channels base_ch*{1,2,4,8,16}.
* Optional CBAM spatial attention at the bottleneck.
* ConvLSTM (``lstm_layers`` deep) over the bottleneck sequence.
* Optional ConvLSTMs on the two deepest skips (x3: 8*base_ch, x2: 4*base_ch).
* Per-frame decoder up3..up0 + 1x1 head.
* Input [B, T, H, W, 2*in_channels_per_sat]; output [B, T, H, W,
  out_channels] and the recurrent state.

The encoder and decoder run batched over T·B frames; only the three
recurrences walk time. A streaming carry (``state``) makes each new frame
cost the same however long a session has run. The module names are the
reference torch model's, so its state dict loads with ``strict=True``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from ..core.dtypes import DEFAULT_POLICY, Policy
from ..ops.blocks import (DoubleConv, Down, OutConv, SpatialAttention, Up,
                          double_conv, down, out_conv, spatial_attention, up)
from ..ops.convlstm import ConvLSTM, convlstm, convlstm_zero_state
from .layout import (flatten_seq, remat_call, to_batch_major, to_time_major,
                     unflatten_seq)


@dataclasses.dataclass(frozen=True)
class TemporalUNetConfig:
    in_channels_per_sat: int = 1
    out_channels: int = 1
    base_ch: int = 32
    lstm_layers: int = 1
    use_skip_lstm: bool = False
    use_attention: bool = False

    @property
    def in_ch_total(self) -> int:
        return self.in_channels_per_sat * 2

    def to_dict(self):
        return dataclasses.asdict(self)


class TemporalUNetDualView(nn.Module):
    def __init__(self, cfg: TemporalUNetConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        bc, g = cfg.base_ch, generator
        self.inc = DoubleConv(cfg.in_ch_total, bc, g)
        self.down1 = Down(bc, bc * 2, g)
        self.down2 = Down(bc * 2, bc * 4, g)
        self.down3 = Down(bc * 4, bc * 8, g)
        self.bottleneck = Down(bc * 8, bc * 16, g)
        if cfg.use_attention:
            self.attention = SpatialAttention(7, g)
        self.temporal = ConvLSTM(bc * 16, bc * 16, cfg.lstm_layers,
                                 generator=g)
        if cfg.use_skip_lstm:
            self.lstm_skip3 = ConvLSTM(bc * 8, bc * 8, generator=g)
            self.lstm_skip2 = ConvLSTM(bc * 4, bc * 4, generator=g)
        self.up3 = Up(bc * 16, bc * 8, g)
        self.up2 = Up(bc * 8, bc * 4, g)
        self.up1 = Up(bc * 4, bc * 2, g)
        self.up0 = Up(bc * 2, bc, g)
        self.outc = OutConv(bc, cfg.out_channels, g)

    def bn_layers(self) -> Dict[Tuple[str, ...], nn.BatchNorm2d]:
        """The BatchNorm behind each leaf of the stats tree that
        ``temporal_unet_apply`` returns, by its path in the tree (an Up
        block nests its DoubleConv's stats under ``conv``)."""
        out = {}
        for name, dc in double_convs(self).items():
            pre = (name, "conv") if name.startswith("up") else (name,)
            out[pre + ("bn1",)] = dc.bn1
            out[pre + ("bn2",)] = dc.bn2
        return out


def temporal_unet_init_state(cfg: TemporalUNetConfig, batch: int,
                             height: int, width: int,
                             dtype: torch.dtype = torch.float32,
                             device=None) -> Dict[str, Any]:
    """Zero recurrent state for streaming (h//16 x w//16 bottleneck)."""
    bc = cfg.base_ch
    state = {"temporal": [convlstm_zero_state(batch, height // 16,
                                              width // 16, bc * 16, dtype,
                                              device)
                          for _ in range(cfg.lstm_layers)]}
    if cfg.use_skip_lstm:
        state["skip3"] = [convlstm_zero_state(batch, height // 8, width // 8,
                                              bc * 8, dtype, device)]
        state["skip2"] = [convlstm_zero_state(batch, height // 4, width // 4,
                                              bc * 4, dtype, device)]
    return state


def double_convs(m: TemporalUNetDualView) -> Dict[str, DoubleConv]:
    """The DoubleConv behind each top-level key of the BatchNorm stats tree
    that ``temporal_unet_apply`` returns."""
    out = {"inc": m.inc}
    for name in ("down1", "down2", "down3", "bottleneck"):
        out[name] = getattr(m, name).net[1]
    for name in ("up3", "up2", "up1", "up0"):
        out[name] = getattr(m, name).conv
    return out


def _encode(m: TemporalUNetDualView, x_bt, train: bool, policy: Policy,
            fused: bool, mesh=None):
    """x_bt [T*B, H, W, Cin] → (bottleneck, skips, new BN stats)."""
    ns: Dict[str, Any] = {}
    x0, ns["inc"] = double_conv(m.inc, x_bt, train, policy, fused, mesh)
    x1, ns["down1"] = down(m.down1, x0, train, policy, fused, mesh)
    x2, ns["down2"] = down(m.down2, x1, train, policy, fused, mesh)
    x3, ns["down3"] = down(m.down3, x2, train, policy, fused, mesh)
    xb, ns["bottleneck"] = down(m.bottleneck, x3, train, policy, fused, mesh)
    if m.cfg.use_attention:
        xb = spatial_attention(m.attention, xb, policy, mesh)
    return xb, (x3, x2, x1, x0), ns


def _decode(m: TemporalUNetDualView, xb_bt, skips_bt, train: bool,
            policy: Policy, fused: bool, mesh=None):
    ns: Dict[str, Any] = {}
    x3, x2, x1, x0 = skips_bt
    d3, ns["up3"] = up(m.up3, xb_bt, x3, train, policy, fused, mesh)
    d2, ns["up2"] = up(m.up2, d3, x2, train, policy, fused, mesh)
    d1, ns["up1"] = up(m.up1, d2, x1, train, policy, fused, mesh)
    d0, ns["up0"] = up(m.up0, d1, x0, train, policy, fused, mesh)
    return out_conv(m.outc, d0, policy, mesh), ns


def temporal_unet_apply(m: TemporalUNetDualView, x_seq: torch.Tensor,
                        state: Optional[Dict[str, Any]] = None,
                        train: bool = False,
                        policy: Policy = DEFAULT_POLICY,
                        use_pallas: bool = False,
                        use_fused_doubleconv: bool = False,
                        unroll: int = 1, remat: bool = False,
                        flat_layout: str = "time", mesh=None
                        ) -> Tuple[torch.Tensor, Dict[str, Any],
                                   Dict[str, Any]]:
    """Forward over a sequence.

    x_seq [B, T, H, W, 2*in_per_sat] → (y_seq [B, T, H, W, out], new_state,
    new BN stats). Pass ``state`` from a previous call to stream.
    ``use_pallas`` runs the ConvLSTM gate update through its kernel and
    ``use_fused_doubleconv`` the DoubleConvs through the fused conv kernel,
    under the JAX package's flag names. ``flat_layout``: the frames' flatten
    order, "time" or "batch" (models/layout.py). ``remat``: the per-frame
    encoder and decoder under ``torch.utils.checkpoint`` (the JAX
    ``jax.checkpoint``): their activations are recomputed in the backward
    instead of kept, and the BatchNorm statistics the recomputation makes
    are discarded (the first forward's are returned). ``unroll``: XLA's
    scan unroll factor in the JAX package; accepted, with no effect on an
    eager time loop. ``mesh`` (``parallel.Mesh``): x_seq is this rank's
    rows of a data-parallel batch, and train-mode BatchNorm takes the
    global batch's statistics; the model's tensor-parallel shards
    (``parallel.tensor.shard_model``) run column-parallel over the mesh's
    model group."""
    del unroll            # no counterpart in eager PyTorch (ROADMAP.md §C)
    cfg = m.cfg
    B, T = x_seq.shape[0], x_seq.shape[1]
    fused = use_fused_doubleconv
    lay = flat_layout

    x_bt = flatten_seq(x_seq, lay)
    xb, skips, enc_stats = remat_call(remat, _encode, m, x_bt, train,
                                        policy, fused, mesh)

    state = state or {}
    xb_out_tm, new_temporal = convlstm(
        m.temporal, to_time_major(xb, B, T, lay),
        state=state.get("temporal"), policy=policy, use_pallas=use_pallas,
        mesh=mesh)
    new_state: Dict[str, Any] = {"temporal": new_temporal}

    x3, x2, x1, x0 = skips
    if cfg.use_skip_lstm:
        x3_out, new_state["skip3"] = convlstm(
            m.lstm_skip3, to_time_major(x3, B, T, lay),
            state=state.get("skip3"), policy=policy, use_pallas=use_pallas,
            mesh=mesh)
        x2_out, new_state["skip2"] = convlstm(
            m.lstm_skip2, to_time_major(x2, B, T, lay),
            state=state.get("skip2"), policy=policy, use_pallas=use_pallas,
            mesh=mesh)
        x3 = to_batch_major(x3_out, B, T, lay)
        x2 = to_batch_major(x2_out, B, T, lay)

    xb_bt = to_batch_major(xb_out_tm, B, T, lay)
    y_bt, dec_stats = remat_call(remat, _decode, m, xb_bt.to(x_bt.dtype),
                                   (x3, x2, x1, x0), train, policy, fused,
                                   mesh)
    y_seq = unflatten_seq(y_bt, B, T, lay)
    return y_seq, new_state, {**enc_stats, **dec_stats}

