"""Model registry — type dispatch from checkpoint-embedded configs
(counterpart of unet_convlstm_tpu/models/registry.py).

A saved config dict determines which model to rebuild: ``custom``
(TemporalUNetDualView) or ``resnet18`` (PretrainedTemporalUNet). Each
model names the BatchNorm layers behind its apply's stats tree
(``bn_layers()``), through which ``commit_bn_stats`` writes a train-mode
forward's new running stats back.
"""

from __future__ import annotations

import warnings
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch import nn

from ..utils.torch_weights import find_resnet18_weights, load_torch_resnet18
from .resnet_unet import (PretrainedTemporalUNet, ResNetUNetConfig,
                          resnet_unet_apply, resnet_unet_init_state)
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
    # The pretrained-weights policy: an explicit pretrained_path is loaded
    # (its errors propagate); with none given, the torch hub cache's places
    # are searched (no network); a frozen encoder without weights is never
    # random: freeze_encoder falls back to False with a warning. A config
    # restored from a trained checkpoint (pretrained_resolved) loads no
    # .pth (the saved weights embody it) and keeps its saved freeze.
    resolved = bool(cfg_dict.get("pretrained_resolved"))
    path = None if resolved else (cfg_dict.get("pretrained_path")
                                  or find_resnet18_weights())
    pretrained = (load_torch_resnet18(path, cfg_dict.get("in_channels", 2))
                  if path else None)
    freeze = cfg_dict.get("freeze_encoder", True)
    if not resolved and freeze and pretrained is None:
        warnings.warn(
            "resnet18 model: freeze_encoder=True but no ImageNet weights "
            "were given (pretrained_path) or found in the torch hub cache "
            "— falling back to freeze_encoder=False so a random encoder "
            "is trained, not frozen. Provide resnet18-*.pth to match the "
            "reference's frozen-ImageNet configuration.", stacklevel=2)
        freeze = False
    # the caller's dict records what runs: the optimizer's trainable mask
    # and the checkpoint-embedded config read it
    cfg_dict["freeze_encoder"] = freeze

    cfg = ResNetUNetConfig(
        out_channels=cfg_dict.get("out_channels", 1),
        lstm_layers=cfg_dict.get("lstm_layers", 2),
        freeze_encoder=freeze,
        in_channels=cfg_dict.get("in_channels", 2),
        encoder_bn_train=cfg_dict.get("encoder_bn_train", False),
    )

    def init(generator: Optional[torch.Generator] = None, device=None):
        """A new model with weights drawn from ``generator`` (on the CPU),
        the pretrained encoder copied in, moved to ``device``."""
        model = PretrainedTemporalUNet(cfg, generator)
        if pretrained is not None:
            model.encoder.load_state_dict(pretrained, strict=True)
        return model.to(device)

    def apply(model, x_seq, state=None, train=False,
              use_fused_doubleconv=False, **kw):
        # use_fused_doubleconv is accepted and not forwarded: the JAX
        # decoder never fuses (unet_convlstm_tpu/models/resnet_unet.py:
        # 181-183)
        return resnet_unet_apply(model, x_seq, state=state, train=train,
                                 **kw)

    def init_state(batch, height, width, device=None):
        return resnet_unet_init_state(cfg, batch, height, width,
                                      device=device)

    return cfg, init, apply, init_state


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


def _leaf(stats: Dict[str, Any], path: Tuple[str, ...]):
    for key in path:
        stats = stats[key]
    return stats


def bn_buffers(model: nn.Module) -> List[torch.Tensor]:
    """Every running mean and var that ``commit_bn_stats`` writes."""
    return [t for bn in model.bn_layers().values()
            for t in (bn.running_mean, bn.running_var)]


@torch.no_grad()
def commit_bn_stats(model: nn.Module, stats: Dict[str, Any]) -> None:
    """Write a train-mode forward's new running (mean, var) into the
    BatchNorm buffers (the JAX train step's ``state["stats"]`` update),
    through the model's ``bn_layers()``."""
    for path, bn in model.bn_layers().items():
        mean, var = _leaf(stats, path)
        bn.running_mean.copy_(mean)
        bn.running_var.copy_(var)
