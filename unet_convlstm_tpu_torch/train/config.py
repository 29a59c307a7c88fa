"""Training configuration: one dataclass tree + CLI overrides (counterpart
of unet_convlstm_tpu/train/config.py; the same keys and defaults, so the
repo's ``configs/*.json`` load unchanged).

Keys the port accepts with another meaning, or none yet:

* ``use_pallas``: the JAX switch for its Pallas kernels. The port's
  trainer runs its hand-written kernels (the ConvLSTM gate update, forward
  and backward, and the fused 3x3 conv) on the card whatever the key says,
  as ``bench`` and ``serve`` do; their plain versions serve the CPU only.
* ``flat_layout``: the frames' flatten order (models/layout.py), "time",
  "batch", or "auto": "batch" on a data mesh (``mesh_data`` > 1), else
  "time", as the JAX ``fit`` resolves it.
* ``remat``: the per-frame encoder and decoder (the ResNet18 family's
  encoder) under ``torch.utils.checkpoint``, where the JAX package puts
  ``jax.checkpoint``: less activation memory, a second forward of them in
  the backward, the same result.
* ``unroll``: XLA's scan unroll factor for the recurrences. Accepted and
  without effect: the port's time loop is eager (ROADMAP.md, section C).
* ``mesh_data`` and ``mesh_model``: the ``(data, model)`` mesh, as in the
  JAX package. ``mesh_data`` > 1 trains data parallel; ``mesh_model`` > 1
  splits every conv kernel by output channel over that many ranks, with
  its AdamW moments (tensor parallel, ``parallel/tensor.py``). The run
  takes ``mesh_data x mesh_model`` processes, launched with torchrun (one
  process a card, or CPU processes); ``zero1`` splits the AdamW moments
  over the data ranks on top. ``mesh_data`` None means ``mesh_data`` 1.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional


@dataclasses.dataclass
class TrainConfig:
    # data
    npz_path: str = ""
    min_y: Optional[float] = None
    max_y: Optional[float] = None
    train_frac: float = 0.8
    split_seed: int = 42
    # optimization
    batch_size: int = 32
    # gradient accumulation: batch_size runs as accum_steps microbatches
    # before each optimizer update
    accum_steps: int = 1
    epochs: int = 200
    lr: float = 1e-3
    weight_decay: float = 1e-4
    grad_clip: float = 1.0
    plateau_factor: float = 0.5
    plateau_patience: int = 3
    min_lr: float = 0.0           # LR floor for plateau + guard cuts
    use_mask: bool = False
    mask_threshold: float = 1.1   # raw-radiance cloud threshold
    # model (type-dispatched)
    model: Dict[str, Any] = dataclasses.field(default_factory=lambda: {
        "type": "custom", "base_ch": 64, "use_attention": False,
        "use_skip_lstm": True, "lstm_layers": 1,
    })
    # runtime
    seed: int = 42
    use_pallas: bool = False      # see the module docstring
    flat_layout: str = "auto"     # "time", "batch" or "auto"
    unroll: int = 10              # accepted, no effect (eager time loop)
    remat: bool = False           # checkpoint the encoder and decoder
    mesh_data: Optional[int] = None   # None or 1: the one card
    mesh_model: int = 1
    zero1: bool = False
    checkpoint_dir: str = "checkpoints"
    # every N healthy epochs the `<model>_last.pt` checkpoint is refreshed,
    # so a cold kill resumes from there instead of the last best epoch;
    # 0 = off (written at the end of the run only)
    save_last_every: int = 0
    tensorboard_dir: str = ""     # optional TensorBoard scalar logging
    log_every: int = 50
    # failure detection (train/guard.py)
    guard: bool = False           # epoch-level rollback on NaN/spiked loss
    guard_spike_factor: float = 10.0  # val loss > factor x median → rollback
    guard_max_events: int = 8     # rollback budget before giving up
    # where the guard keeps its rollback snapshot: "device" (a copy on the
    # card) or "host" (host memory, frees device memory)
    guard_snapshot: str = "device"
    skip_nonfinite_updates: Optional[int] = None  # non-finite gradient skip:
    # max consecutive skipped steps (optax.apply_if_finite), None = off

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TrainConfig":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})

    def apply_overrides(self, overrides: Dict[str, str]) -> "TrainConfig":
        """Apply 'key=value' CLI overrides ('model.base_ch=32' supported).
        Coerces by the current value's type; None-defaulted fields
        (mesh_data, min_y, ...) parse as int/float/bool/None literals."""
        d = self.to_dict()
        for key, val in overrides.items():
            tgt = d
            parts = key.split(".")
            # a typo'd top-level key fails loudly ('model.*' stays open:
            # model configs are type-specific dicts)
            if parts[0] not in d:
                raise KeyError(
                    f"unknown config key {parts[0]!r} in override {key!r}; "
                    f"valid keys: {sorted(d)}")
            for p in parts[:-1]:
                tgt = tgt[p]
            old = tgt.get(parts[-1])
            if isinstance(old, bool):
                tgt[parts[-1]] = val.lower() in ("1", "true", "yes")
            elif isinstance(old, int):
                tgt[parts[-1]] = int(val)
            elif isinstance(old, float):
                tgt[parts[-1]] = float(val)
            elif old is None:
                if val.lower() in ("none", "null"):
                    tgt[parts[-1]] = None
                elif val.lower() in ("true", "false", "yes", "no"):
                    tgt[parts[-1]] = val.lower() in ("true", "yes")
                else:
                    try:
                        tgt[parts[-1]] = int(val)
                    except ValueError:
                        try:
                            tgt[parts[-1]] = float(val)
                        except ValueError:
                            tgt[parts[-1]] = val
            else:
                tgt[parts[-1]] = val
        return TrainConfig.from_dict(d)


def check_mesh(cfg: TrainConfig) -> None:
    """Raise for mesh keys that name no mesh: degrees below 1. Data
    parallelism, tensor parallelism and ZeRO-1 run."""
    if cfg.mesh_model < 1 or (cfg.mesh_data is not None
                              and cfg.mesh_data < 1):
        raise ValueError(f"mesh_data={cfg.mesh_data} mesh_model="
                         f"{cfg.mesh_model}: the degrees must be >= 1")
