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

An int8-quantized JAX tree (``quantize_tree``, optionally with calibrated
``x_s``) carries across too: ``w_q``/``wt_q`` become the int8 ``weight``
in the same layouts, ``w_s``/``wt_s`` the ``w_s`` buffer and ``x_s`` the
``x_s`` buffer of the port's ``QuantConv2d``/``QuantConvTranspose2d``;
``ops.quant.load_quantized_state_dict`` loads the result into a model from
``quantize_model``.

Checkpoints of the reference's torch code (``{model_state, config,
val_loss, epoch}``, reference main.py:307-323), the CLI's
``convert-checkpoint``: ``read_reference_checkpoint`` loads one safely,
``reference_model_config`` takes the architecture from its weights where
its config says otherwise or nothing (the JAX CLI's rule), and
``to_reference_checkpoint`` writes a checkpoint of this package back in
that format.
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


def _int8_to_oihw(w) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.transpose(
        np.asarray(w, np.int8), (3, 2, 0, 1))))


def _conv(out: Dict[str, torch.Tensor], prefix: str, p) -> None:
    """A conv leaf, float (``w``) or int8 (``w_q``, ``w_s``, ``x_s``), or
    a transposed one (``wt``, or ``wt_q``, ``wt_s``, ``x_s``)."""
    q = "w_q" if "w_q" in p else "wt_q" if "wt_q" in p else None
    if q is None:
        out[f"{prefix}.weight"] = _hwio_to_oihw(p["wt"] if "wt" in p
                                                else p["w"])
    else:
        out[f"{prefix}.weight"] = _int8_to_oihw(p[q])
        out[f"{prefix}.w_s"] = _t(p["w_s" if q == "w_q" else "wt_s"])
        if "x_s" in p:
            out[f"{prefix}.x_s"] = _t(p["x_s"])
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
        _conv(out, "attention.conv", p["attention"])
    for name in ("up3", "up2", "up1", "up0"):
        _conv(out, f"{name}.up", p[name]["up"])
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


# ---------------------------------------------------------------------------
# The reference's checkpoints (convert-checkpoint)
# ---------------------------------------------------------------------------

# the model-config keys the reference .pt carries, per family
REFERENCE_CONFIG_KEYS = {
    "custom": ("base_ch", "lstm_layers", "use_skip_lstm", "use_attention"),
    "resnet18": ("lstm_layers", "freeze_encoder", "in_channels")}


def read_reference_checkpoint(path: str) -> Dict[str, Any]:
    """A reference ``.pt``, loaded with ``weights_only=True``: it holds
    tensors and plain containers. Where that load fails, a warning comes
    before the full unpickling, which runs whatever code the file holds:
    only for files one trusts."""
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except Exception as e:  # any refusal of the safe unpickler
        print(f"WARNING: safe (weights_only) load failed ({e}); falling "
              "back to full unpickling — only do this for checkpoints you "
              "trust.")
        return torch.load(path, map_location="cpu", weights_only=False)


def custom_structure(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """TemporalUNetDualView's architecture read from its weights: skip
    LSTMs, attention, LSTM depth, base width, input channels per satellite
    (the first conv sees both satellites' stacked channels, reference
    unet.py:134) and output channels (the 1x1 head, unet.py:159)."""
    return {
        "use_skip_lstm": "lstm_skip3.layers.0.conv.weight" in sd,
        "use_attention": "attention.conv.weight" in sd,
        "lstm_layers": sum(1 for k in sd if k.startswith("temporal.layers.")
                           and k.endswith(".conv.weight")),
        "base_ch": int(sd["inc.net.0.weight"].shape[0]),
        "in_channels_per_sat": int(sd["inc.net.0.weight"].shape[1]) // 2,
        "out_channels": int(sd["outc.conv.weight"].shape[0]),
    }


def reference_model_config(ckpt: Mapping[str, Any], model_type: str
                           ) -> Dict[str, Any]:
    """The model config of a reference checkpoint (or of a raw state dict,
    with ``model_type`` as its family): its own config, where the custom
    family's structural flags come from the weights, with a warning where
    they contradict it (a raw state dict or a minimal config would
    otherwise get the registry's defaults and fail to load). ``type`` is
    set where the file's config lacks it."""
    sd = ckpt.get("model_state", ckpt)
    cfg = dict(ckpt.get("config", {"type": model_type}))
    cfg.setdefault("type", model_type)
    if cfg["type"] == "custom":
        for k, v in custom_structure(sd).items():
            if k in cfg and cfg[k] != v:
                print(f"WARNING: checkpoint config says {k}={cfg[k]} but "
                      f"the weights say {k}={v}; trusting the weights")
            cfg[k] = v
    elif cfg["type"] != "resnet18":
        raise ValueError(f"unknown model type {cfg['type']!r}")
    return cfg


def to_reference_checkpoint(model_state: Mapping[str, torch.Tensor],
                            meta: Mapping[str, Any]) -> Dict[str, Any]:
    """A checkpoint of this package (``train.checkpoint.restore_checkpoint``
    output) → the reference's ``{model_state, config, val_loss, epoch}``,
    the config cut to the keys the reference reads. The ResNet18 family
    gains the reference's ``lstm_skips.0`` (the LSTM over the identity
    feature, whose output its decoder drops) zero-filled, as the JAX
    package's ``export_pretrained_temporal_unet_checkpoint`` writes it."""
    if meta.get("int8"):
        raise ValueError("an int8 checkpoint has no float weights for the "
                         "reference; export the float checkpoint")
    cfg = meta.get("config", {})
    model_cfg = cfg.get("model", cfg)
    model_type = model_cfg.get("type", "custom")
    if model_type not in REFERENCE_CONFIG_KEYS:
        raise ValueError(f"unknown model type {model_type!r}")
    sd = {k: v.detach().cpu() for k, v in model_state.items()}
    if model_type == "resnet18":
        cin = int(sd["encoder.conv1.weight"].shape[1])
        layers = sum(1 for k in sd if k.startswith("lstm_skips.1.layers.")
                     and k.endswith(".conv.weight"))
        for layer in range(layers):
            pre = f"lstm_skips.0.layers.{layer}.conv"
            sd[f"{pre}.weight"] = torch.zeros(4 * cin, 2 * cin, 3, 3)
            sd[f"{pre}.bias"] = torch.zeros(4 * cin)
    return {"model_state": sd,
            "config": {"type": model_type,
                       **{k: model_cfg[k] for k in
                          REFERENCE_CONFIG_KEYS[model_type]
                          if k in model_cfg}},
            "val_loss": meta.get("val_loss"),
            "epoch": meta.get("epoch", 0)}
