"""Optimizer: global-norm clip, then AdamW, with frozen parameters, a
non-finite skip and a run-time learning rate (counterpart of
unet_convlstm_tpu/train/optim.py, which builds the same chain from optax).

* ``clip_by_global_norm(grad_clip)`` as optax computes it: the global norm
  over the trainable gradients; when it is at least ``grad_clip`` every
  gradient is scaled by ``grad_clip / norm`` (torch's ``clip_grad_norm_``
  scales by ``max / (norm + 1e-6)`` and is not used).
* optax's ``adamw``: b1 0.9, b2 0.999, eps 1e-8 outside the square root,
  weight decay decoupled and scaled by the learning rate, over every
  trainable parameter. ``torch.optim.AdamW`` computes exactly this.
* Frozen parameters (``trainable_mask`` False) get no update and no decay,
  as optax's ``multi_transform`` with ``set_to_zero``.
* ``skip_nonfinite``: optax's ``apply_if_finite``. A step whose gradients
  hold a NaN or Inf leaves parameters and moments untouched, unless it is
  the ``skip_nonfinite + 1``-th such step in a row, which is applied.
  ``notfinite_count`` counts the bad steps in a row (0 after a finite
  one), ``total_notfinite`` all of them. The decision needs the verdict on
  the host: one synchronisation per step, only with the skip on.
* ``ReduceLROnPlateau``: torch's semantics (mode 'min', relative threshold
  1e-4, cooldown 0) on the validation loss, host-side.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

import torch
from torch import nn


def all_finite(grads: List[torch.Tensor]) -> bool:
    if not grads:
        return True
    return bool(torch.stack([torch.isfinite(g).all() for g in grads]).all())


def clip_by_global_norm_(grads: List[torch.Tensor],
                         max_norm: float) -> torch.Tensor:
    """optax's ``clip_by_global_norm`` in place; returns the norm. No host
    synchronisation: the scale is chosen on the device."""
    if not grads:
        return torch.zeros(())
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    scale = torch.where(norm < max_norm, torch.ones_like(norm),
                        max_norm / norm)
    torch._foreach_mul_(grads, scale)
    return norm


class Optimizer:
    """Clip, then AdamW, over the trainable ones of ``named_params``; the
    update reads each parameter's ``.grad``."""

    def __init__(self, named_params: Iterable[Tuple[str, nn.Parameter]],
                 lr: float, weight_decay: float = 1e-4,
                 grad_clip: float = 1.0,
                 trainable_mask: Optional[Dict[str, bool]] = None,
                 skip_nonfinite: Optional[int] = None):
        named = list(named_params)
        mask = trainable_mask or {}
        self.params = [p for _, p in named]
        self.trainable = [p for n, p in named if mask.get(n, True)]
        self.grad_clip = grad_clip
        self.skip_nonfinite = skip_nonfinite
        self.adamw = torch.optim.AdamW(self.trainable, lr=lr,
                                       betas=(0.9, 0.999), eps=1e-8,
                                       weight_decay=weight_decay)
        # apply_if_finite's counters
        self.notfinite_count = 0
        self.total_notfinite = 0

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def grads(self) -> List[torch.Tensor]:
        return [p.grad for p in self.params if p.grad is not None]

    def step(self) -> bool:
        """One update from the current gradients; returns whether it was
        applied. A trainable parameter without a gradient counts as a zero
        gradient, as in optax (its moments decay, weight decay applies)."""
        if self.skip_nonfinite is not None:
            if all_finite(self.grads()):
                self.notfinite_count = 0
            else:
                self.notfinite_count += 1
                self.total_notfinite += 1
                if self.notfinite_count <= self.skip_nonfinite:
                    return False
        for p in self.trainable:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        clip_by_global_norm_([p.grad for p in self.trainable],
                             self.grad_clip)
        self.adamw.step()
        return True


def make_optimizer(named_params: Iterable[Tuple[str, nn.Parameter]],
                   lr: float, weight_decay: float = 1e-4,
                   grad_clip: float = 1.0,
                   trainable_mask: Optional[Dict[str, bool]] = None,
                   skip_nonfinite: Optional[int] = None) -> Optimizer:
    """``named_params``: ``model.named_parameters()``. ``trainable_mask``:
    parameter name → bool; False freezes it (missing names train)."""
    return Optimizer(named_params, lr, weight_decay, grad_clip,
                     trainable_mask, skip_nonfinite)


def nonfinite_step_count(opt: Optimizer) -> int:
    """Updates rejected as non-finite so far (0 without ``skip_nonfinite``)."""
    return opt.total_notfinite


def get_learning_rate(opt: Optimizer) -> float:
    return float(opt.adamw.param_groups[0]["lr"])


def set_learning_rate(opt: Optimizer, lr: float) -> None:
    """Set the learning rate of every later update, in place."""
    for group in opt.adamw.param_groups:
        group["lr"] = lr


class ReduceLROnPlateau:
    """torch-semantics plateau scheduler (mode='min', rel threshold 1e-4,
    cooldown 0)."""

    def __init__(self, lr: float, factor: float = 0.5, patience: int = 3,
                 threshold: float = 1e-4, min_lr: float = 0.0):
        self.lr = lr
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.min_lr = min_lr
        self.best = float("inf")
        self.num_bad = 0

    def step(self, val_loss: float) -> float:
        """Feed the epoch's val loss; returns the (possibly reduced) LR."""
        if val_loss < self.best * (1.0 - self.threshold):
            self.best = val_loss
            self.num_bad = 0
        else:
            self.num_bad += 1
        if self.num_bad > self.patience:
            self.lr = max(self.lr * self.factor, self.min_lr)
            self.num_bad = 0
        return self.lr

    def state_dict(self):
        return {"lr": self.lr, "best": self.best, "num_bad": self.num_bad}

    def load_state_dict(self, d):
        self.lr, self.best, self.num_bad = d["lr"], d["best"], d["num_bad"]
