"""Model registry — type dispatch from checkpoint-embedded configs
(counterpart of unet_convlstm_tpu/models/registry.py).

A saved config dict determines which model to rebuild. The port has the
custom TemporalUNetDualView; the ResNet18-UNet family is not ported yet.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from .temporal_unet import (TemporalUNetConfig, TemporalUNetDualView,
                            temporal_unet_apply, temporal_unet_init_state)


def _build_custom(cfg_dict: Dict[str, Any]):
    # Defaults mirror the reference's production driver config (base_ch 64,
    # skip-LSTMs on), not the dataclass defaults (base_ch 32, skip-LSTMs
    # off); checkpoints embed the fully resolved dict.
    cfg = TemporalUNetConfig(
        in_channels_per_sat=cfg_dict.get("in_channels_per_sat", 1),
        out_channels=cfg_dict.get("out_channels", 1),
        base_ch=cfg_dict.get("base_ch", 64),
        lstm_layers=cfg_dict.get("lstm_layers", 1),
        use_skip_lstm=cfg_dict.get("use_skip_lstm", True),
        use_attention=cfg_dict.get("use_attention", False),
    )

    def init(generator: Optional[torch.Generator] = None, device=None):
        """A new model with weights drawn from ``generator`` (on the CPU)
        and moved to ``device``."""
        return TemporalUNetDualView(cfg, generator).to(device)

    def apply(model, x_seq, state=None, train=False, **kw):
        return temporal_unet_apply(model, x_seq, state=state, train=train,
                                   **kw)

    def init_state(batch, height, width, device=None):
        return temporal_unet_init_state(cfg, batch, height, width,
                                        device=device)

    return cfg, init, apply, init_state


def _build_resnet18(cfg_dict: Dict[str, Any]):
    raise NotImplementedError(
        "model type 'resnet18' is not ported to unet_convlstm_tpu_torch yet "
        "(ROADMAP.md, queue A item 4: ResNet18 family)")


MODEL_REGISTRY: Dict[str, Callable] = {
    "custom": _build_custom,
    "resnet18": _build_resnet18,
}


def build_model(cfg_dict: Dict[str, Any]
                ) -> Tuple[Any, Callable, Callable, Callable]:
    """Returns (cfg, init_fn, apply_fn, init_state_fn) for a config dict with
    a 'type' key ('custom' by default)."""
    model_type = cfg_dict.get("type", "custom")
    if model_type not in MODEL_REGISTRY:
        raise ValueError(f"unknown model type {model_type!r}; "
                         f"known: {sorted(MODEL_REGISTRY)}")
    return MODEL_REGISTRY[model_type](cfg_dict)
