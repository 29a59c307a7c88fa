"""Weights carried over from the JAX package (counterpart of the export half
of unet_convlstm_tpu/utils/torch_weights.py).

``state_dict_from_jax`` turns the JAX package's TemporalUNetDualView
``{"params", "stats"}`` tree, given as numpy arrays, into this package's
state dict under the reference torch model's names. It is this package's
own copy of ``export_temporal_unet_checkpoint``: the same layouts, with no
import from the JAX package. A JAX checkpoint reaches the port through it,
run where JAX is installed (numpy leaves via ``jax.device_get``).

Layouts: conv kernels HWIO → OIHW (``transpose(3, 2, 0, 1)``); transposed-
conv kernels HWOI (``wt``) → torch's (in, out, kh, kw), the same transpose.
"""

from __future__ import annotations

from typing import Any, Dict

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
    """JAX TemporalUNetDualView ``{"params", "stats"}`` (numpy leaves) →
    this package's (and the reference model's) state dict."""
    p, s = variables["params"], variables["stats"]
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
