"""Checkpoint I/O, torch ``.pt`` files (counterpart of
unet_convlstm_tpu/train/checkpoint.py).

The JAX package keeps Orbax directories (a ``state`` tree and a
``meta.json``), which cannot be read without JAX. This package writes one
reference-format ``.pt`` per checkpoint instead:

    {"model_state": state dict (reference module names),
     "config":      the model config dict ({"type": "custom", ...}, or a
                    training config holding it under "model"),
     "norm_stats":  the NormStats dict serving needs,
     ...            any further keys}

A training checkpoint (``<checkpoint_dir>/<model>_{best,last}.pt``, written
by ``train.loop.fit``) adds ``optimizer`` (``Optimizer.state_dict()``: the
AdamW moments and step, the non-finite skip counters) and the JAX
``meta.json`` keys ``val_loss``, ``epoch``, ``scheduler`` and ``guard``, so
training resumes exactly; serving reads the same file.

A save writes a temporary file in the same directory, fsyncs it and renames
it over the target (one ``os.replace``): a kill at any point leaves the old
file or the new one, never a mix. This one rename replaces the JAX
package's two-file staging (``state.next`` + ``meta.json.next``). A stale
temporary file from a killed save is never read. A JAX checkpoint is
carried over with ``utils.torch_weights.state_dict_from_jax`` where JAX is
installed.
"""

from __future__ import annotations

import glob
import os
from typing import Any, Dict, Mapping, Optional, Tuple

import torch


def save_checkpoint(path: str, model_state: Mapping[str, torch.Tensor],
                    config: Dict[str, Any],
                    norm_stats: Optional[Dict[str, Any]] = None,
                    **extra: Any) -> str:
    """Write a reference-format ``.pt`` atomically; tensors are saved from
    the CPU. ``extra`` keys (optimizer, epoch, ...) go in beside them."""
    blob: Dict[str, Any] = {
        "model_state": {k: v.detach().cpu() for k, v in model_state.items()},
        "config": dict(config),
    }
    if norm_stats is not None:
        blob["norm_stats"] = dict(norm_stats)
    blob.update(extra)
    path = os.path.abspath(path)
    folder = os.path.dirname(path)
    os.makedirs(folder, exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            torch.save(blob, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    # make the rename itself durable
    fd = os.open(folder, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)
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


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """The most recently written ``.pt`` in ``ckpt_dir`` (by mtime), or
    None; temporary files of unfinished saves are not candidates."""
    paths = glob.glob(os.path.join(ckpt_dir, "*.pt"))
    return max(paths, key=os.path.getmtime) if paths else None
