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
* ZeRO-1 (``zero1`` with a data-parallel ``mesh``): each rank keeps the
  AdamW moments of its slice of each trainable parameter, the slice
  ``MeshRules.opt_state_spec`` picks (the largest dimension the data degree
  divides; a parameter with none keeps whole moments on every rank). The
  step reads the gradients already summed over the ranks, so clipping and
  the non-finite verdict see the full gradients and every rank agrees;
  AdamW updates the rank's slice with the same elementwise arithmetic as
  the replicated update, and an all-gather puts the slices together in
  every rank's parameter. ``state_dict`` gathers the moments (a checkpoint
  holds the replicated optimizer's tensors) and ``load_state_dict`` slices
  them again.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

import torch
from torch import nn

from ..parallel.mesh import MeshRules


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
                 skip_nonfinite: Optional[int] = None, mesh=None,
                 zero1: bool = False):
        named = list(named_params)
        mask = trainable_mask or {}
        self.params = [p for _, p in named]
        self.trainable = [p for n, p in named if mask.get(n, True)]
        self.grad_clip = grad_clip
        self.skip_nonfinite = skip_nonfinite
        self.mesh = mesh
        # ZeRO-1: (index in trainable, parameter, axis, this rank's slice);
        # AdamW steps the slice in the parameter's place
        self.shards: List[Tuple[int, nn.Parameter, int, torch.Tensor]] = []
        stepped = list(self.trainable)
        if zero1 and mesh is not None and mesh.distributed:
            rules = MeshRules(mesh, shard_opt_state_data=True)
            for i, (n, p) in enumerate((n, p) for n, p in named
                                       if mask.get(n, True)):
                axis = rules.zero1_axis(n, p)
                if axis is not None:
                    shard = self._slice(p.detach(), axis).clone()
                    self.shards.append((i, p, axis, shard))
                    stepped[i] = shard
        self.adamw = torch.optim.AdamW(stepped, lr=lr,
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
        with torch.no_grad():
            for _, p, axis, shard in self.shards:
                # the parameter may have been loaded since the last step
                shard.copy_(self._slice(p, axis))
                shard.grad = self._slice(p.grad, axis).contiguous()
        self.adamw.step()
        if self.shards:
            with torch.no_grad():
                full = self._gather([s for _, _, _, s in self.shards])
                for (_, p, _, _), t in zip(self.shards, full):
                    p.copy_(t)
        return True

    def _slice(self, t: torch.Tensor, axis: int) -> torch.Tensor:
        n = t.shape[axis] // self.mesh.data
        return t.narrow(axis, self.mesh.rank * n, n)

    def _gather(self, slices: List[torch.Tensor]) -> List[torch.Tensor]:
        """The whole tensors of the ranks' slices (one all-gather): each
        slice of ``self.shards``' layout, concatenated in rank order."""
        flat = self.mesh.all_gather(
            torch.cat([s.reshape(-1) for s in slices]))
        ranks = flat.view(self.mesh.data, -1)
        out, off = [], 0
        for (_, _, axis, _), s in zip(self.shards, slices):
            n = s.numel()
            out.append(torch.cat([r[off:off + n].view(s.shape)
                                  for r in ranks], dim=axis))
            off += n
        return out

    def state_dict(self) -> Dict:
        """AdamW's moments, step and learning rate, and the skip counters
        (live tensors: copy before mutating). Under ZeRO-1 the moments are
        gathered from the ranks (a collective: every rank calls it), so the
        dict holds what the replicated optimizer would."""
        adamw = self.adamw.state_dict()
        if self.shards and adamw["state"]:
            state = {i: dict(st) for i, st in adamw["state"].items()}
            for key in ("exp_avg", "exp_avg_sq"):
                full = self._gather([state[i][key]
                                     for i, _, _, _ in self.shards])
                for (i, _, _, _), t in zip(self.shards, full):
                    state[i][key] = t
            adamw = {**adamw, "state": state}
        return {"adamw": adamw,
                "notfinite_count": self.notfinite_count,
                "total_notfinite": self.total_notfinite}

    def load_state_dict(self, d: Dict) -> None:
        """Restore a ``state_dict`` of an optimizer over the same trainable
        parameters; the moments move to the parameters' device. Under
        ZeRO-1 each rank keeps its slices of the moments."""
        adamw = d["adamw"]
        if self.shards and adamw["state"]:
            state = {i: dict(st) for i, st in adamw["state"].items()}
            for i, _, axis, _ in self.shards:
                for key in ("exp_avg", "exp_avg_sq"):
                    state[i][key] = self._slice(state[i][key], axis).clone()
            adamw = {**adamw, "state": state}
        self.adamw.load_state_dict(adamw)
        self.notfinite_count = int(d["notfinite_count"])
        self.total_notfinite = int(d["total_notfinite"])


def make_optimizer(named_params: Iterable[Tuple[str, nn.Parameter]],
                   lr: float, weight_decay: float = 1e-4,
                   grad_clip: float = 1.0,
                   trainable_mask: Optional[Dict[str, bool]] = None,
                   skip_nonfinite: Optional[int] = None, mesh=None,
                   zero1: bool = False) -> Optimizer:
    """``named_params``: ``model.named_parameters()``. ``trainable_mask``:
    parameter name → bool; False freezes it (missing names train).
    ``mesh`` and ``zero1``: the moments split over the data-parallel ranks
    (ZeRO-1; see the module's docstring)."""
    return Optimizer(named_params, lr, weight_decay, grad_clip,
                     trainable_mask, skip_nonfinite, mesh, zero1)


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
