"""PretrainedTemporalUNet — ResNet18-UNet with a ConvLSTM bottleneck and
skips (counterpart of unet_convlstm_tpu/models/resnet_unet.py).

* Encoder: ResNet18, features at /2 (64 channels), /4 (64), /8 (128),
  /16 (256) and /32 (512); optionally frozen and optionally initialised
  from a local torchvision-format ``.pth`` (``utils/torch_weights.py``).
* Decoder (the smp UnetDecoder topology): 5 blocks of [nearest 2x
  upsample, concat(upsampled, skip), (3x3 conv + BN + ReLU) x 2] with
  widths 256, 128, 64, 32, 16, then a 3x3 head conv with bias.
* ConvLSTM(512 → 512, ``lstm_layers`` deep) over the bottleneck sequence,
  and one per skip level, 64, 64, 128 and 256 channels.
* Input [B, T, H, W, in_channels] with H, W divisible by 32; output [B, T,
  H, W, out_channels], the recurrent state and the BatchNorm stats.

The module names are the reference PretrainedTemporalUNet's (the JAX
package's export names them the same): ``encoder.*`` (torchvision),
``decoder.blocks.{i}.conv{1,2}.{0,1}``, ``segmentation_head.0``,
``lstm.layers.{l}.conv`` and ``lstm_skips.{1..4}.layers.{l}.conv``. The
reference also builds ``lstm_skips.0`` over the stage-0 identity feature,
whose output its decoder drops: it has no module here, and
``load_state_dict`` drops its keys from a reference state dict.

Frozen encoder (``freeze_encoder`` without ``encoder_bn_train``): its
BatchNorm runs in inference mode, the returned encoder stats are its
running stats, and it runs under ``torch.no_grad()`` (JAX's
``stop_gradient``). With ``encoder_bn_train`` it uses and updates batch
statistics, as the reference does.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn

from ..core import trace
from ..core.dtypes import DEFAULT_POLICY, Policy
from ..ops.blocks import double_conv
from ..ops.conv import Conv2d, batchnorm, conv2d, max_pool2d
from ..ops.convlstm import ConvLSTM, convlstm, convlstm_zero_state
from .layout import (flatten_seq, remat_call, to_batch_major, to_time_major,
                     unflatten_seq)

ENCODER_CHANNELS = (64, 64, 128, 256, 512)   # stages 1..5
DECODER_CHANNELS = (256, 128, 64, 32, 16)
SKIP_DIVISORS = (2, 4, 8, 16)


@dataclasses.dataclass(frozen=True)
class ResNetUNetConfig:
    out_channels: int = 1
    lstm_layers: int = 2
    freeze_encoder: bool = True
    in_channels: int = 2
    encoder_bn_train: bool = False

    def to_dict(self):
        return dataclasses.asdict(self)


# ---------------------------------------------------------------------------
# ResNet18 encoder (torchvision names)
# ---------------------------------------------------------------------------

class BasicBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, stride: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.stride = stride
        self.conv1 = Conv2d(in_ch, out_ch, 3, bias=False, generator=g)
        self.bn1 = nn.BatchNorm2d(out_ch)
        self.conv2 = Conv2d(out_ch, out_ch, 3, bias=False, generator=g)
        self.bn2 = nn.BatchNorm2d(out_ch)
        self.downsample = None
        if stride != 1 or in_ch != out_ch:
            self.downsample = nn.Sequential(
                Conv2d(in_ch, out_ch, 1, bias=False, generator=g),
                nn.BatchNorm2d(out_ch))


class ResNet18Encoder(nn.Module):
    def __init__(self, in_channels: int = 2,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.conv1 = Conv2d(in_channels, 64, 7, bias=False, generator=g)
        self.bn1 = nn.BatchNorm2d(64)
        plan = [(64, 64, 1), (64, 128, 2), (128, 256, 2), (256, 512, 2)]
        for li, (cin, cout, stride) in enumerate(plan, start=1):
            setattr(self, f"layer{li}", nn.Sequential(
                BasicBlock(cin, cout, stride, g),
                BasicBlock(cout, cout, 1, g)))

    def blocks(self):
        """(stats key, block) of the eight basic blocks in order."""
        for li in range(1, 5):
            for bi, blk in enumerate(getattr(self, f"layer{li}")):
                yield f"layer{li}_{bi}", blk


def _basic_block(blk: BasicBlock, x: torch.Tensor, train: bool,
                 policy: Policy, mesh=None):
    ns: Dict[str, Any] = {}
    # explicit symmetric pads: "SAME" pads (0, 1) under stride 2, torch's
    # resnet (1, 1)
    y = conv2d(x, blk.conv1, stride=blk.stride,
               padding=[(1, 1), (1, 1)], policy=policy, mesh=mesh)
    y, ns["bn1"] = batchnorm(blk.bn1, y, train, mesh=mesh)
    y = torch.relu(y)
    y = conv2d(y, blk.conv2, policy=policy, mesh=mesh)
    y, ns["bn2"] = batchnorm(blk.bn2, y, train, mesh=mesh)
    if blk.downsample is not None:
        sc = conv2d(x, blk.downsample[0], stride=blk.stride,
                    padding="VALID", policy=policy, mesh=mesh)
        sc, ns["down_bn"] = batchnorm(blk.downsample[1], sc, train,
                                      mesh=mesh)
    else:
        sc = x
    return torch.relu(y + sc.to(y.dtype)), ns


def resnet18_encoder_apply(enc: ResNet18Encoder, x: torch.Tensor,
                           train: bool, policy: Policy = DEFAULT_POLICY,
                           mesh=None
                           ) -> Tuple[List[torch.Tensor], Dict[str, Any]]:
    """x [N, H, W, C] → 5 features at /2, /4, /8, /16, /32 and the new BN
    stats."""
    ns: Dict[str, Any] = {}
    y = conv2d(x, enc.conv1, stride=2, padding=[(3, 3), (3, 3)],
               policy=policy, mesh=mesh)
    y, ns["bn1"] = batchnorm(enc.bn1, y, train, mesh=mesh)
    f1 = torch.relu(y)                                     # /2, 64
    y = max_pool2d(f1, 3, 2, padding=1)                    # /4, -inf pads
    feats = [f1]
    for key, blk in enc.blocks():
        y, ns[key] = _basic_block(blk, y, train, policy, mesh)
        if key.endswith("_1"):
            feats.append(y)
    return feats, ns


# ---------------------------------------------------------------------------
# UNet decoder (smp topology)
# ---------------------------------------------------------------------------

class _ConvBNReLU(nn.Sequential):
    """smp's Conv2dReLU (``0`` conv, ``1`` BN, ``2`` ReLU); ``weight`` and
    ``bias`` are its conv's, which ``ops.blocks.double_conv`` reads."""

    def __init__(self, in_ch: int, out_ch: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__(Conv2d(in_ch, out_ch, 3, generator=generator),
                         nn.BatchNorm2d(out_ch), nn.ReLU())

    weight = property(lambda self: self[0].weight)
    bias = property(lambda self: self[0].bias)


class DecoderBlock(nn.Module):
    """``conv1`` and ``conv2`` with ``bn1``/``bn2`` views: the attributes
    ``ops.blocks.double_conv`` applies."""

    def __init__(self, in_ch: int, out_ch: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv1 = _ConvBNReLU(in_ch, out_ch, generator)
        self.conv2 = _ConvBNReLU(out_ch, out_ch, generator)

    bn1 = property(lambda self: self.conv1[1])
    bn2 = property(lambda self: self.conv2[1])


class UnetDecoder(nn.Module):
    def __init__(self, generator: Optional[torch.Generator] = None):
        super().__init__()
        in_chs = (ENCODER_CHANNELS[-1],) + DECODER_CHANNELS[:-1]
        skip_chs = tuple(reversed(ENCODER_CHANNELS[:-1])) + (0,)
        self.blocks = nn.ModuleList(
            DecoderBlock(cin + cskip, cout, generator)
            for cin, cskip, cout in zip(in_chs, skip_chs, DECODER_CHANNELS))


def _upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest 2x of NHWC (``jnp.repeat`` on both axes)."""
    n, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(n, h, 2, w, 2, c).reshape(
        n, 2 * h, 2 * w, c)


def decoder_apply(dec: UnetDecoder, head: Conv2d,
                  features: List[torch.Tensor], train: bool,
                  policy: Policy = DEFAULT_POLICY, mesh=None):
    ns: Dict[str, Any] = {}
    skips = features[:-1][::-1]  # [/16, /8, /4, /2]
    y = features[-1]
    for i, blk in enumerate(dec.blocks):
        y = _upsample2x(y)
        if i < len(skips):
            y = torch.cat([y, skips[i].to(y.dtype)], dim=-1)
        # never fused: the JAX decoder does not pass fused=True
        # (unet_convlstm_tpu/models/resnet_unet.py:181-183)
        y, ns[f"block{i}"] = double_conv(blk, y, train, policy, mesh=mesh)
    return conv2d(y, head, policy=policy, mesh=mesh), ns


# ---------------------------------------------------------------------------
# The temporal model
# ---------------------------------------------------------------------------

class PretrainedTemporalUNet(nn.Module):
    def __init__(self, cfg: ResNetUNetConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        g = generator
        self.encoder = ResNet18Encoder(cfg.in_channels, g)
        self.decoder = UnetDecoder(g)
        self.segmentation_head = nn.Sequential(
            Conv2d(DECODER_CHANNELS[-1], cfg.out_channels, 3, generator=g))
        self.lstm = ConvLSTM(512, 512, cfg.lstm_layers, generator=g)
        self.lstm_skips = nn.ModuleDict({
            str(i + 1): ConvLSTM(ch, ch, cfg.lstm_layers, generator=g)
            for i, ch in enumerate(ENCODER_CHANNELS[:-1])})

    def bn_layers(self) -> Dict[Tuple[str, ...], nn.BatchNorm2d]:
        """The BatchNorm behind each leaf of the stats tree that
        ``resnet_unet_apply`` returns, by its path in the tree."""
        enc = self.encoder
        out = {("encoder", "bn1"): enc.bn1}
        for key, blk in enc.blocks():
            out["encoder", key, "bn1"] = blk.bn1
            out["encoder", key, "bn2"] = blk.bn2
            if blk.downsample is not None:
                out["encoder", key, "down_bn"] = blk.downsample[1]
        for i, blk in enumerate(self.decoder.blocks):
            out["decoder", f"block{i}", "bn1"] = blk.bn1
            out["decoder", f"block{i}", "bn2"] = blk.bn2
        return out

    def load_state_dict(self, state_dict, strict: bool = True,
                        assign: bool = False):
        """A reference state dict's ``lstm_skips.0.*`` (the LSTM over the
        identity feature, whose output the reference's decoder drops) is
        dropped; with ``strict`` every other key must match."""
        state_dict = {k: v for k, v in state_dict.items()
                      if not k.startswith("lstm_skips.0.")}
        return super().load_state_dict(state_dict, strict=strict,
                                       assign=assign)


def resnet_unet_init_state(cfg: ResNetUNetConfig, batch: int, height: int,
                           width: int, dtype: torch.dtype = torch.float32,
                           device=None) -> Dict[str, Any]:
    """Zero recurrent state for streaming."""
    state: Dict[str, Any] = {
        "temporal": [convlstm_zero_state(batch, height // 32, width // 32,
                                         512, dtype, device)
                     for _ in range(cfg.lstm_layers)]}
    for i, (ch, d) in enumerate(zip(ENCODER_CHANNELS[:-1], SKIP_DIVISORS)):
        state[f"skip{i}"] = [convlstm_zero_state(batch, height // d,
                                                 width // d, ch, dtype,
                                                 device)
                             for _ in range(cfg.lstm_layers)]
    return state


def resnet_unet_apply(m: PretrainedTemporalUNet, x_seq: torch.Tensor,
                      state: Optional[Dict[str, Any]] = None,
                      train: bool = False,
                      policy: Policy = DEFAULT_POLICY,
                      use_pallas: bool = False, unroll: int = 1,
                      remat: bool = False, flat_layout: str = "time",
                      mesh=None
                      ) -> Tuple[torch.Tensor, Dict[str, Any],
                                 Dict[str, Any]]:
    """x_seq [B, T, H, W, in_channels] → (y_seq [B, T, H, W, out],
    new_state, {"encoder", "decoder"} BN stats). H and W must be divisible
    by 32. ``use_pallas`` runs every ConvLSTM's gate update through its
    kernel. ``flat_layout``: "time" or "batch" (models/layout.py).
    ``remat``: the encoder under ``torch.utils.checkpoint``, as the JAX
    package puts ``jax.checkpoint`` there (a frozen encoder runs without
    gradients and keeps nothing to recompute). ``unroll``: accepted, no
    effect (XLA's scan unroll). ``mesh``: train-mode BatchNorm over the
    data-parallel global batch, and the model's tensor-parallel shards
    column-parallel over its model group. The encoder, the ConvLSTM
    stacks and the decoder with its head run inside the spans
    ``model.encoder``, ``model.recurrence`` and ``model.decoder``
    (``core/trace.py``), with device events on a card."""
    del unroll            # no counterpart in eager PyTorch (ROADMAP.md §C)
    cfg = m.cfg
    B, T = x_seq.shape[0], x_seq.shape[1]
    lay = flat_layout
    x_bt = flatten_seq(x_seq, lay)

    frozen = cfg.freeze_encoder and not cfg.encoder_bn_train
    dev = x_seq.device
    with trace.span("model.encoder", device=dev), \
            torch.no_grad() if frozen else contextlib.nullcontext():
        # frozen: inference-mode BN, whose "new" stats are the running ones
        feats, enc_stats = remat_call(
            remat and not frozen, resnet18_encoder_apply, m.encoder, x_bt,
            train and not frozen, policy, mesh)

    state = state or {}
    new_state: Dict[str, Any] = {}
    recurrences = [("temporal", m.lstm, len(feats) - 1)] + [
        (f"skip{i}", m.lstm_skips[str(i + 1)], i)
        for i in range(len(ENCODER_CHANNELS) - 1)]
    with trace.span("model.recurrence", device=dev):
        for key, lstm, i in recurrences:
            out, new_state[key] = convlstm(
                lstm, to_time_major(feats[i], B, T, lay),
                state=state.get(key), policy=policy, use_pallas=use_pallas,
                mesh=mesh)
            feats[i] = to_batch_major(out, B, T, lay).to(x_bt.dtype)

    with trace.span("model.decoder", device=dev):
        y_bt, dec_stats = decoder_apply(m.decoder, m.segmentation_head[0],
                                        feats, train, policy, mesh)
        y_seq = unflatten_seq(y_bt, B, T, lay)
    return y_seq, new_state, {"encoder": enc_stats, "decoder": dec_stats}
