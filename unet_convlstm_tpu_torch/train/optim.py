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
  the host: one synchronisation per step, only with the skip on (the
  ``optim.verdict`` span, ``core/trace.py``).
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
* Tensor parallelism (a ``mesh`` with ``model`` > 1 and a model narrowed
  by ``parallel.tensor.shard_model``): a shard's moments are the shard's
  own, and ZeRO-1 splits them over 'data' on the axis the composed JAX
  rule picks (never the 'model' one). The global norm adds the shards'
  squared norms over the model group to the replicated leaves' (counted
  once), and the non-finite verdict is agreed over the model group, so
  every rank clips and skips alike. ``state_dict`` gathers the shards'
  moments too (a one-process optimizer's tensors), and
  ``load_state_dict`` narrows them.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

import torch
from torch import nn

from ..core import trace
from ..parallel.mesh import MeshRules
from ..parallel.tensor import model_axis


def all_finite(grads: List[torch.Tensor]) -> bool:
    if not grads:
        return True
    return bool(torch.stack([torch.isfinite(g).all() for g in grads]).all())


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float,
                         sharded: Optional[List[bool]] = None,
                         mesh=None) -> torch.Tensor:
    """optax's ``clip_by_global_norm`` in place; returns the norm. No host
    synchronisation: the scale is chosen on the device. ``sharded``
    (with a tensor-parallel ``mesh``): which gradients are model shards,
    whose squared norms are summed over the model group."""
    if not grads:
        return torch.zeros(())
    norms = torch.stack(torch._foreach_norm(grads))
    if mesh is None or mesh.model == 1 or not any(sharded or ()):
        norm = torch.linalg.vector_norm(norms)
    else:
        sq = norms.square()
        mask = torch.tensor(sharded, device=sq.device)
        norm = (sq[~mask].sum()
                + mesh.all_reduce(sq[mask].sum(), axis="model")).sqrt()
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
        # tensor parallelism: (index in trainable, model axis) of the shards
        self.model_shards = [(i, model_axis(p))
                             for i, p in enumerate(self.trainable)
                             if model_axis(p) is not None]
        if self.model_shards and (mesh is None or mesh.model == 1):
            raise ValueError("a model with tensor-parallel shards needs its "
                             "mesh (mesh= with model > 1)")
        self.sharded = [model_axis(p) is not None for p in self.trainable]
        # ZeRO-1: (index in trainable, parameter, axis, this rank's slice);
        # AdamW steps the slice in the parameter's place
        self.shards: List[Tuple[int, nn.Parameter, int, torch.Tensor]] = []
        stepped = list(self.trainable)
        if zero1 and mesh is not None and mesh.distributed:
            rules = MeshRules(mesh, shard_model_channels=mesh.model > 1,
                              shard_opt_state_data=True)
            for i, (n, p) in enumerate((n, p) for n, p in named
                                       if mask.get(n, True)):
                axis = rules.zero1_axis(n, _whole(p, mesh))
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

    def grads_finite(self) -> bool:
        """Whether every gradient is finite, agreed over the model group
        under tensor parallelism (a shard's verdict is its own)."""
        grads = self.grads()
        if not self.model_shards:
            return all_finite(grads)
        bad = torch.stack([~torch.isfinite(g).all() for g in grads]
                          ).sum().float() if grads else torch.zeros(())
        return float(self.mesh.all_reduce(bad, axis="model")) == 0

    def step(self) -> bool:
        """One update from the current gradients; returns whether it was
        applied. A trainable parameter without a gradient counts as a zero
        gradient, as in optax (its moments decay, weight decay applies)."""
        if self.skip_nonfinite is not None:
            with trace.span("optim.verdict"):
                finite = self.grads_finite()
            if finite:
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
                             self.grad_clip, self.sharded, self.mesh)
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
        return self.mesh.block(t, axis)

    def _gather(self, slices: List[torch.Tensor]) -> List[torch.Tensor]:
        """The whole tensors of the data ranks' slices (one all-gather),
        each of ``self.shards``' layout."""
        return self.mesh.gather_blocks(
            slices, [axis for _, _, axis, _ in self.shards])

    def state_dict(self) -> Dict:
        """AdamW's moments, step and learning rate, and the skip counters
        (live tensors: copy before mutating). Under ZeRO-1 the moments are
        gathered from the ranks (a collective: every rank calls it), so the
        dict holds what the replicated optimizer would; under tensor
        parallelism the shards' moments are gathered too, so it holds what
        one process's optimizer would."""
        adamw = self.adamw.state_dict()
        if (self.shards or self.model_shards) and adamw["state"]:
            state = {i: dict(st) for i, st in adamw["state"].items()}
            for key in ("exp_avg", "exp_avg_sq"):
                if self.shards:
                    full = self._gather([state[i][key]
                                         for i, _, _, _ in self.shards])
                    for (i, _, _, _), t in zip(self.shards, full):
                        state[i][key] = t
                if self.model_shards:
                    full = self.mesh.gather_blocks(
                        [state[i][key] for i, _ in self.model_shards],
                        [a for _, a in self.model_shards], "model")
                    for (i, _), t in zip(self.model_shards, full):
                        state[i][key] = t
            adamw = {**adamw, "state": state}
        return {"adamw": adamw,
                "notfinite_count": self.notfinite_count,
                "total_notfinite": self.total_notfinite}

    def load_state_dict(self, d: Dict) -> None:
        """Restore a ``state_dict`` of an optimizer over the same trainable
        parameters; the moments move to the parameters' device. Under
        tensor parallelism each rank keeps its shards' blocks, and under
        ZeRO-1 its slices of those."""
        adamw = d["adamw"]
        if (self.shards or self.model_shards) and adamw["state"]:
            state = {i: dict(st) for i, st in adamw["state"].items()}
            for i, axis in self.model_shards:
                for key in ("exp_avg", "exp_avg_sq"):
                    state[i][key] = self.mesh.block(state[i][key], axis,
                                                    "model")
            for i, _, axis, _ in self.shards:
                for key in ("exp_avg", "exp_avg_sq"):
                    state[i][key] = self._slice(state[i][key], axis).clone()
            adamw = {**adamw, "state": state}
        self.adamw.load_state_dict(adamw)
        self.notfinite_count = int(d["notfinite_count"])
        self.total_notfinite = int(d["total_notfinite"])


def _whole(p: torch.Tensor, mesh) -> torch.Tensor:
    """A tensor of the whole parameter's shape (on the meta device) for
    a tensor-parallel shard, the parameter itself otherwise: the
    partition rules read the whole shape."""
    axis = model_axis(p)
    if axis is None:
        return p
    shape = list(p.shape)
    shape[axis] *= mesh.model
    return torch.empty(shape, dtype=p.dtype, device="meta")


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
