"""Train and eval steps (counterpart of unet_convlstm_tpu/train/steps.py).

One training step:

    raw batch → mask/normalize (ops.normalize) → forward (model apply,
    train mode) → weighted-L1 + gradient loss → backward → clip + AdamW →
    commit the new BatchNorm running stats → denormalized metric sums

The JAX step is a pure function of a state pytree; here the state lives in
the model (parameters and BatchNorm buffers) and the optimizer, which the
step updates in place. It returns (loss, sums) as device tensors and does
not synchronise with the host, except to decide the non-finite skip when
that is on. Its spans (``core/trace.py``): ``step``, and inside it
``step.forward`` (normalize to loss), ``step.backward`` (the backward and
the gradients' sum over the ranks) and ``step.optim`` (clip and AdamW),
the last three timed on the card as well.

``apply_fn(model, x_seq, train=...)`` → (y_seq, state, new_bn_stats), with
the policy and kernel flags bound (``functools.partial`` of the registry's
apply). Batches are raw NHWC tensors [B, T, H, W, C] on the model's device.

Data parallel (``mesh``, a ``parallel.Mesh`` of D ranks): each rank passes
its B/D rows of the global batch (``batch_sharding(mesh).local``) and the
step computes what one device computes on the global batch, as the JAX
step does under ``jit`` with a 'data'-sharded batch: BatchNorm's batch
statistics over the global batch (the mesh is bound into the model's
apply), the loss's means and masked denominators global (each rank's loss
is its share), the gradients summed over the ranks once before the
optimizer, the loss and the metric sums summed. Every rank ends with the
same parameters, BatchNorm statistics and returned values.

Tensor parallel (``state_sharding``, ``MeshRules(shard_model_channels=
True).tree_sharding`` of the model's state, on a mesh with ``model`` > 1):
the model holds its rank's shards (``parallel.tensor.shard_model``), and
the step computes the same function. Each sharded conv runs
column-parallel inside the model's apply (the mesh bound into it); the
model ranks hold the same rows, so the loss, the BatchNorm statistics and
the metric sums are summed over the data group only, as are the
gradients: a shard's gradient is its own, and a replicated leaf's is
already the whole one, the same bits on every model rank. The optimizer
(built over the sharded model with the same mesh) clips by the global
norm over the model group and agrees on the non-finite verdict.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional, Tuple

import torch

from ..core import trace
from ..models.registry import bn_buffers, commit_bn_stats
from ..ops.losses import compute_loss
from ..ops.normalize import (NormStats, compute_mask, denormalize_y,
                             normalize_x, normalize_y)
from ..parallel.mesh import (Mesh, data_mesh, resolve_sharding,
                             sum_gradients)
from ..parallel.tensor import check_sharded
from .metrics import MetricSums, metric_sums_init, metric_sums_update
from .optim import Optimizer


def _sum_sums(sums: MetricSums, mesh: Optional[Mesh]) -> MetricSums:
    """The metric sums over the ranks (one collective)."""
    if mesh is None:
        return sums
    return MetricSums(*mesh.all_reduce(torch.stack(list(sums))).unbind())




def _update_was_finite(opt: Optimizer) -> bool:
    """The ``_guarded_bn`` rule: the optimizer's own verdict when it runs
    the non-finite skip (its count resets to 0 on a finite step, so the
    two never disagree), else the gradients' finiteness."""
    if opt.skip_nonfinite is not None:
        return opt.notfinite_count == 0
    return opt.grads_finite()


@torch.no_grad()
def _sums(acc: MetricSums, y_pred, y, mask, use_mask: bool,
          norm_stats: NormStats) -> MetricSums:
    return metric_sums_update(
        acc, denormalize_y(y_pred.float(), norm_stats),
        denormalize_y(y, norm_stats), mask, use_mask)


def _make_step_core(apply_fn: Callable, norm_stats: NormStats,
                    use_mask: bool, grad_weight: float,
                    guard_nonfinite_stats: bool = False,
                    mesh: Optional[Mesh] = None):
    """The single step. ``guard_nonfinite_stats`` (set when the optimizer
    runs the non-finite skip): a batch with non-finite gradients leaves ALL
    persistent state untouched. The skip covers parameters and moments;
    the BatchNorm running stats are committed outside the optimizer, so
    the step commits them only when the update was finite."""

    def step(model, opt: Optimizer, x_raw: torch.Tensor,
             y_raw: torch.Tensor) -> Tuple[torch.Tensor, MetricSums]:
        dev = x_raw.device
        with trace.span("step"):
            with trace.span("step.forward", device=dev):
                x = normalize_x(x_raw, norm_stats)
                y = normalize_y(y_raw, norm_stats)
                mask = compute_mask(x_raw, norm_stats)
                opt.zero_grad()
                y_pred, _, new_bn = apply_fn(model, x, train=True)
                loss = compute_loss(y_pred, y, mask, use_mask,
                                    grad_weight=grad_weight, mesh=mesh)
            with trace.span("step.backward", device=dev):
                loss.backward()
                sum_gradients(opt.grads(), mesh)
            with trace.span("step.optim", device=dev):
                opt.step()
            if not guard_nonfinite_stats or _update_was_finite(opt):
                commit_bn_stats(model, new_bn)
            sums = _sums(metric_sums_init(dev), y_pred, y, mask, use_mask,
                         norm_stats)
            if mesh is None:
                return loss.detach(), sums
            return mesh.all_reduce(loss.detach()), _sum_sums(sums, mesh)

    return step


def _make_accum_step_core(apply_fn: Callable, norm_stats: NormStats,
                          use_mask: bool, grad_weight: float,
                          accum_steps: int,
                          guard_nonfinite_stats: bool = False,
                          mesh: Optional[Mesh] = None):
    """Gradient accumulation: the [B] batch runs as ``accum_steps``
    microbatches, each differentiated at the SAME parameters; their mean
    gradient makes ONE optimizer update. Only one microbatch's activations
    are alive at a time. Microbatch k holds rows {k, k+K, k+2K, ...} (the
    JAX package's strided split). BatchNorm batch statistics are per
    microbatch and the running stats thread through them; a masked loss
    normalizes per microbatch, and the reported loss is their mean.

    With a mesh each rank passes its B/D consecutive rows; as K·D divides
    B, its rows {k, k+K, ...} are its part of global microbatch k (the
    split is the same on any number of devices), and K·D must divide B, as
    the JAX step requires."""
    K = accum_steps
    D = mesh.data if mesh is not None else 1

    def step(model, opt: Optimizer, x_raw: torch.Tensor,
             y_raw: torch.Tensor) -> Tuple[torch.Tensor, MetricSums]:
        B = x_raw.shape[0] * D
        if B % K:
            raise ValueError(
                f"batch size {B} is not divisible by accum_steps={K} — "
                f"gradient accumulation splits the batch into K equal "
                f"microbatches")
        if (B // K) % D:
            raise ValueError(
                f"microbatch {B // K} (batch {B} / accum_steps={K}) is not "
                f"divisible by the mesh data degree {D} — each microbatch "
                f"must shard evenly over 'data' (same rule fit() enforces)")
        with trace.span("step"):
            dev = x_raw.device
            snap = ([t.clone() for t in bn_buffers(model)]
                    if guard_nonfinite_stats else None)
            opt.zero_grad()
            loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
            sums = metric_sums_init(dev)
            for k in range(K):
                with trace.span("step.forward", device=dev):
                    x_r, y_r = x_raw[k::K], y_raw[k::K]
                    x = normalize_x(x_r, norm_stats)
                    y = normalize_y(y_r, norm_stats)
                    mask = compute_mask(x_r, norm_stats)
                    y_pred, _, new_bn = apply_fn(model, x, train=True)
                    loss = compute_loss(y_pred, y, mask, use_mask,
                                        grad_weight=grad_weight, mesh=mesh)
                with trace.span("step.backward", device=dev):
                    loss.backward()           # sums into .grad
                commit_bn_stats(model, new_bn)
                loss_sum = loss_sum + loss.detach().float()
                sums = _sums(sums, y_pred, y, mask, use_mask, norm_stats)
            with trace.span("step.backward", device=dev):
                grads = opt.grads()
                if grads:
                    torch._foreach_div_(grads, float(K))
                sum_gradients(grads, mesh)
            with trace.span("step.optim", device=dev):
                opt.step()
            if guard_nonfinite_stats and not _update_was_finite(opt):
                with torch.no_grad():
                    torch._foreach_copy_(bn_buffers(model), snap)
            if mesh is None:
                return loss_sum / K, sums
            return mesh.all_reduce(loss_sum) / K, _sum_sums(sums, mesh)

    return step


def make_train_step(apply_fn: Callable, norm_stats: NormStats,
                    use_mask: bool = False, grad_weight: float = 0.005,
                    mesh=None, state_sharding=None,
                    guard_nonfinite_stats: bool = False,
                    accum_steps: int = 1):
    """Build the step: (model, optimizer, x_raw, y_raw) → (loss, sums).

    ``accum_steps > 1``: gradient accumulation over that many microbatches
    of B/accum_steps rows before the single update. ``mesh``: data
    parallel (see the module's docstring): x_raw and y_raw are this rank's
    rows, and the optimizer is built with the same mesh (its ZeRO-1 option
    splits the moments over it). ``state_sharding``: tensor-parallel
    training (see the module's docstring); its mesh stands in for a
    missing ``mesh``, and the model passed to the step must hold the
    shards it names."""
    mesh, sharding = resolve_sharding(state_sharding, mesh, "state_sharding")
    mesh = data_mesh(mesh)
    if mesh is not None:
        apply_fn = functools.partial(apply_fn, mesh=mesh)
    if accum_steps > 1:
        step = _make_accum_step_core(apply_fn, norm_stats, use_mask,
                                     grad_weight, accum_steps,
                                     guard_nonfinite_stats, mesh)
    else:
        step = _make_step_core(apply_fn, norm_stats, use_mask, grad_weight,
                               guard_nonfinite_stats, mesh)
    return _checked(step, sharding)


def _checked(step, sharding):
    """``step`` that first checks its model holds ``sharding``'s shards."""
    if sharding is None:
        return step

    @functools.wraps(step)
    def checked(model, *args):
        check_sharded(model, sharding)
        return step(model, *args)

    return checked


def make_multi_train_step(apply_fn: Callable, norm_stats: NormStats,
                          use_mask: bool = False, grad_weight: float = 0.005,
                          mesh=None, guard_nonfinite_stats: bool = False,
                          accum_steps: int = 1):
    """K training steps a call: (model, optimizer, x_raw [K, B, ...],
    y_raw [K, B, ...]) → (losses [K], the metric sums summed over the K
    steps).

    The counterpart of the JAX package's ``lax.scan`` over the step body:
    step k runs ``make_train_step``'s step on batch k (this rank's rows of
    it under a ``mesh``), in order, threading the parameters, the
    BatchNorm statistics and the optimizer state, so K calls of the
    single step give the same bits. ``accum_steps`` > 1 composes: each of
    the K steps accumulates over its own batch. A non-finite step under
    ``guard_nonfinite_stats`` keeps its host verdict, step by step."""
    step = make_train_step(apply_fn, norm_stats, use_mask=use_mask,
                           grad_weight=grad_weight, mesh=mesh,
                           guard_nonfinite_stats=guard_nonfinite_stats,
                           accum_steps=accum_steps)

    def multi_step(model, opt: Optimizer, x_raw: torch.Tensor,
                   y_raw: torch.Tensor) -> Tuple[torch.Tensor, MetricSums]:
        K = x_raw.shape[0]
        if K < 1 or y_raw.shape[0] != K:
            raise ValueError(f"x_raw and y_raw must be [K, B, ...] with the "
                             f"same K >= 1, got {tuple(x_raw.shape)} and "
                             f"{tuple(y_raw.shape)}")
        losses, sums = [], []
        for k in range(K):
            loss, s = step(model, opt, x_raw[k], y_raw[k])
            losses.append(loss)
            sums.append(torch.stack(list(s)))
        return torch.stack(losses), MetricSums(
            *torch.stack(sums).sum(dim=0).unbind())

    return multi_step


def make_eval_step(apply_fn: Callable, norm_stats: NormStats,
                   use_mask: bool = False, grad_weight: float = 0.005,
                   mesh=None, variables_sharding=None):
    """(model, x_raw, y_raw, n_valid) → (loss, sums), eval mode.

    ``n_valid``: the number of real rows; the rest are padding that keeps a
    tail batch at full size, and they carry zero weight. ``mesh``: x_raw
    and y_raw are this rank's rows of the global batch, ``n_valid`` counts
    the global batch's real rows, and the loss and sums are the global
    batch's. ``variables_sharding``: tensor parallel, as
    ``make_train_step``'s ``state_sharding``."""
    mesh, sharding = resolve_sharding(variables_sharding, mesh,
                                      "variables_sharding")
    mesh = data_mesh(mesh)
    if mesh is not None and mesh.model > 1:
        apply_fn = functools.partial(apply_fn, mesh=mesh)

    @torch.inference_mode()
    def step(model, x_raw: torch.Tensor, y_raw: torch.Tensor,
             n_valid: int) -> Tuple[torch.Tensor, MetricSums]:
        B = x_raw.shape[0]
        row0 = mesh.data_rank * B if mesh is not None else 0
        valid = (torch.arange(row0, row0 + B, device=x_raw.device)
                 < n_valid).float()
        x = normalize_x(x_raw, norm_stats)
        y = normalize_y(y_raw, norm_stats)
        mask = compute_mask(x_raw, norm_stats)
        y_pred, _, _ = apply_fn(model, x, train=False)
        loss = compute_loss(y_pred, y, mask, use_mask,
                            grad_weight=grad_weight, sample_weight=valid,
                            mesh=mesh)
        vmask = valid.reshape((-1,) + (1,) * (y.dim() - 1))
        sums = _sums(metric_sums_init(x_raw.device), y_pred, y,
                     mask * vmask if use_mask else vmask, True, norm_stats)
        if mesh is None:
            return loss, sums
        return mesh.all_reduce(loss), _sum_sums(sums, mesh)

    return _checked(step, sharding)

