"""Checkpoint I/O, torch ``.pt`` files (counterpart of the restore side of
unet_convlstm_tpu/train/checkpoint.py).

The JAX package keeps Orbax directories, which cannot be read without
JAX. This package reads and writes the reference's torch format instead:

    {"model_state": state dict (reference module names),
     "config":      the model config dict ({"type": "custom", ...}, or a
                    training config holding it under "model"),
     "norm_stats":  the NormStats dict serving needs}

the same ``config`` and ``norm_stats`` a JAX checkpoint's ``meta.json``
holds. A JAX checkpoint is carried over with
``utils.torch_weights.state_dict_from_jax`` where JAX is installed.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import torch


def save_checkpoint(path: str, model_state: Mapping[str, torch.Tensor],
                    config: Dict[str, Any],
                    norm_stats: Optional[Dict[str, Any]] = None) -> str:
    """Write a reference-format ``.pt``; tensors are saved from the CPU."""
    blob: Dict[str, Any] = {
        "model_state": {k: v.detach().cpu() for k, v in model_state.items()},
        "config": dict(config),
    }
    if norm_stats is not None:
        blob["norm_stats"] = dict(norm_stats)
    torch.save(blob, path)
    return path


def restore_checkpoint(path: str
                       ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """Returns (model_state on the CPU, metadata: every other key).

    Loaded with ``weights_only=True``: a checkpoint holds tensors and plain
    containers only, so a third-party file cannot run code on load."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(blob, dict) or "model_state" not in blob:
        raise ValueError(f"{path}: not a reference-format checkpoint "
                         "(expected a dict with 'model_state')")
    meta = {k: v for k, v in blob.items() if k != "model_state"}
    meta.setdefault("config", {})
    return blob["model_state"], meta
