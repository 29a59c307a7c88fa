"""Weights carried over from the JAX package, and the ResNet18 encoder's
``.pth`` files (counterpart of unet_convlstm_tpu/utils/torch_weights.py).

``state_dict_from_jax`` turns a JAX ``{"params", "stats"}`` tree, given as
numpy arrays, into this package's state dict under the reference torch
model's names: TemporalUNetDualView (``export_temporal_unet_checkpoint``)
or, when the tree has an ``encoder``, PretrainedTemporalUNet
(``export_pretrained_temporal_unet_checkpoint`` less the reference's dead
``lstm_skips.0``). It is this package's own copy, with no import from the
JAX package. A JAX checkpoint reaches the port through it, run where JAX is
installed (numpy leaves via ``jax.device_get``).

The encoder's ``.pth`` (torchvision resnet18 names, no network):
``load_torch_resnet18`` reads one for ``model.encoder`` (the first conv
adapted to the model's input channels as smp does: channels cycled mod 3,
rescaled by 3 / new_in), ``save_resnet18_encoder_pth`` writes a model's
encoder as one, and ``find_resnet18_weights`` looks in the torch hub
cache's places.

Layouts: conv kernels HWIO → OIHW (``transpose(3, 2, 0, 1)``); transposed-
conv kernels HWOI (``wt``) → torch's (in, out, kh, kw), the same transpose.
"""

from __future__ import annotations

import glob
import os
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _hwio_to_oihw(w) -> torch.Tensor:
    return _t(np.ascontiguousarray(np.transpose(np.asarray(w, np.float32),
                                                (3, 2, 0, 1))))


def _conv(out: Dict[str, torch.Tensor], prefix: str, p) -> None:
    out[f"{prefix}.weight"] = _hwio_to_oihw(p["w"])
    if "b" in p:
        out[f"{prefix}.bias"] = _t(p["b"])


def _bn(out: Dict[str, torch.Tensor], prefix: str, p, s) -> None:
    out[f"{prefix}.weight"] = _t(p["scale"])
    out[f"{prefix}.bias"] = _t(p["bias"])
    out[f"{prefix}.running_mean"] = _t(s["mean"])
    out[f"{prefix}.running_var"] = _t(s["var"])
    out[f"{prefix}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)


def _double_conv(out, prefix: str, p, s) -> None:
    """JAX {conv1, bn1, conv2, bn2} → ``<prefix>.net.{0,1,3,4}``."""
    _conv(out, f"{prefix}.net.0", p["conv1"])
    _bn(out, f"{prefix}.net.1", p["bn1"], s["bn1"])
    _conv(out, f"{prefix}.net.3", p["conv2"])
    _bn(out, f"{prefix}.net.4", p["bn2"], s["bn2"])


def _convlstm(out, prefix: str, p) -> None:
    for name, cell in p.items():
        _conv(out, f"{prefix}.layers.{int(name[len('layer'):])}.conv",
              cell["conv"])


def state_dict_from_jax(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX TemporalUNetDualView or ResNet18-UNet ``{"params", "stats"}``
    (numpy leaves) → this package's (and the reference model's) state
    dict."""
    p, s = variables["params"], variables["stats"]
    if "encoder" in p:
        return _resnet_state_dict(p, s)
    out: Dict[str, torch.Tensor] = {}
    _double_conv(out, "inc", p["inc"], s["inc"])
    for name in ("down1", "down2", "down3", "bottleneck"):
        _double_conv(out, f"{name}.net.1", p[name], s[name])
    _convlstm(out, "temporal", p["temporal"])
    if "skip3" in p:
        _convlstm(out, "lstm_skip3", p["skip3"])
        _convlstm(out, "lstm_skip2", p["skip2"])
    if "attention" in p:
        out["attention.conv.weight"] = _hwio_to_oihw(p["attention"]["w"])
    for name in ("up3", "up2", "up1", "up0"):
        u = p[name]["up"]
        out[f"{name}.up.weight"] = _hwio_to_oihw(u["wt"] if "wt" in u
                                                 else u["w"])
        if "b" in u:
            out[f"{name}.up.bias"] = _t(u["b"])
        _double_conv(out, f"{name}.conv", p[name]["conv"], s[name]["conv"])
    _conv(out, "outc.conv", p["outc"])
    return out


# ---------------------------------------------------------------------------
# The ResNet18-UNet family
# ---------------------------------------------------------------------------

def _encoder(out, prefix: str, p, s) -> None:
    """JAX encoder tree → torchvision names under ``prefix``."""
    _conv(out, f"{prefix}conv1", p["conv1"])
    _bn(out, f"{prefix}bn1", p["bn1"], s["bn1"])
    for li in range(1, 5):
        for bi in range(2):
            src, dst = f"layer{li}_{bi}", f"{prefix}layer{li}.{bi}"
            bp, bs = p[src], s[src]
            _conv(out, f"{dst}.conv1", bp["conv1"])
            _conv(out, f"{dst}.conv2", bp["conv2"])
            _bn(out, f"{dst}.bn1", bp["bn1"], bs["bn1"])
            _bn(out, f"{dst}.bn2", bp["bn2"], bs["bn2"])
            if "down_conv" in bp:
                _conv(out, f"{dst}.downsample.0", bp["down_conv"])
                _bn(out, f"{dst}.downsample.1", bp["down_bn"], bs["down_bn"])


def _resnet_state_dict(p, s) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    _encoder(out, "encoder.", p["encoder"], s["encoder"])
    dp, ds = p["decoder"], s["decoder"]
    for i in range(5):
        bp, bs = dp[f"block{i}"], ds[f"block{i}"]
        pre = f"decoder.blocks.{i}"
        _conv(out, f"{pre}.conv1.0", bp["conv1"])
        _conv(out, f"{pre}.conv2.0", bp["conv2"])
        _bn(out, f"{pre}.conv1.1", bp["bn1"], bs["bn1"])
        _bn(out, f"{pre}.conv2.1", bp["bn2"], bs["bn2"])
    _conv(out, "segmentation_head.0", dp["head"])
    _convlstm(out, "lstm", p["temporal"])
    # the reference's lstm_skips.0 (over the identity feature, dropped by
    # its decoder) has no counterpart: skip{i} is lstm_skips.{i + 1}
    for i in range(4):
        _convlstm(out, f"lstm_skips.{i + 1}", p[f"skip{i}"])
    return out


def _adapt_first_conv(w_oihw: np.ndarray, in_channels: int) -> np.ndarray:
    """smp-style first-conv channel adaptation (cycle mod 3, rescale)."""
    if in_channels == w_oihw.shape[1]:
        return w_oihw
    out = np.stack([w_oihw[:, i % w_oihw.shape[1]]
                    for i in range(in_channels)], axis=1)
    return out * (w_oihw.shape[1] / in_channels)


def _encoder_keys(sd: Mapping[str, Any]):
    """The torchvision resnet18 encoder's keys (no ``fc``): conv weights
    and BN (weight, bias, running_mean, running_var, num_batches_tracked),
    downsample where ``sd`` has one."""
    bn = ("weight", "bias", "running_mean", "running_var",
          "num_batches_tracked")
    keys = ["conv1.weight"] + [f"bn1.{k}" for k in bn]
    for li in range(1, 5):
        for bi in range(2):
            pre = f"layer{li}.{bi}"
            keys += [f"{pre}.conv1.weight", f"{pre}.conv2.weight"]
            keys += [f"{pre}.{b}.{k}" for b in ("bn1", "bn2") for k in bn]
            if f"{pre}.downsample.0.weight" in sd:
                keys.append(f"{pre}.downsample.0.weight")
                keys += [f"{pre}.downsample.1.{k}" for k in bn]
    return keys


def load_torch_resnet18(path: str, in_channels: int = 2
                        ) -> Dict[str, torch.Tensor]:
    """A local torchvision resnet18 ``.pth`` → the state dict that
    ``model.encoder`` loads with ``strict=True``: f32 weights and stats,
    the first conv adapted to ``in_channels``, ``fc`` left out, and a
    ``num_batches_tracked`` of 0 where the file has none."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    out: Dict[str, torch.Tensor] = {}
    for k in _encoder_keys(sd):
        if k.endswith("num_batches_tracked"):
            out[k] = torch.as_tensor(sd.get(k, 0), dtype=torch.int64).clone()
        else:
            v = sd[k]
            out[k] = (v.detach().to("cpu", torch.float32, copy=True)
                      if isinstance(v, torch.Tensor) else _t(v))
    out["conv1.weight"] = _t(_adapt_first_conv(out["conv1.weight"].numpy(),
                                               in_channels))
    return out


def export_resnet18_encoder_state_dict(model_state: Mapping[str, Any]
                                       ) -> Dict[str, torch.Tensor]:
    """A PretrainedTemporalUNet state dict (``model.state_dict()`` or a
    checkpoint's ``model_state``) → its encoder in torchvision resnet18
    naming (``conv1.weight``, ``bn1.*``, ``layer{1..4}.{0,1}.*``), what
    ``load_torch_resnet18`` reads. The save side of local encoder
    pretraining: train the family on a local task, export its encoder,
    and feed the ``.pth`` back as ``pretrained_path``."""
    pre = "encoder."
    return {k[len(pre):]: v.detach().to("cpu", copy=True)
            for k, v in model_state.items() if k.startswith(pre)}


def save_resnet18_encoder_pth(model_state: Mapping[str, Any],
                              path: str) -> str:
    """Write the encoder of a PretrainedTemporalUNet state dict as a
    torchvision-format ``.pth`` for ``pretrained_path``."""
    torch.save(export_resnet18_encoder_state_dict(model_state), path)
    return path


def find_resnet18_weights(root: Optional[str] = None) -> Optional[str]:
    """Locate a ``resnet18-*.pth`` in the torch hub cache's layout, without
    any network access. Searched (first hit wins): an explicit ``root``,
    ``$TORCH_HOME``, ``~/.cache/torch`` and ``./data``, each with
    ``hub/checkpoints``, ``checkpoints`` or nothing after it. Returns the
    path or None."""
    bases = []
    if root:
        bases.append(root)
    if os.environ.get("TORCH_HOME"):
        bases.append(os.environ["TORCH_HOME"])
    bases += [os.path.expanduser("~/.cache/torch"), "./data"]
    for base in bases:
        for sub in ("hub/checkpoints", "checkpoints", ""):
            hits = sorted(glob.glob(os.path.join(base, sub,
                                                 "resnet18-*.pth")))
            if hits:
                return hits[0]
    return None
