"""Train and eval steps (counterpart of unet_convlstm_tpu/train/steps.py).

One training step:

    raw batch → mask/normalize (ops.normalize) → forward (model apply,
    train mode) → weighted-L1 + gradient loss → backward → clip + AdamW →
    commit the new BatchNorm running stats → denormalized metric sums

The JAX step is a pure function of a state pytree; here the state lives in
the model (parameters and BatchNorm buffers) and the optimizer, which the
step updates in place. It returns (loss, sums) as device tensors and does
not synchronise with the host, except to decide the non-finite skip when
that is on.

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
"""

from __future__ import annotations

import functools
from typing import Callable, Optional, Tuple

import torch

from ..models.registry import bn_buffers, commit_bn_stats
from ..ops.losses import compute_loss
from ..ops.normalize import (NormStats, compute_mask, denormalize_y,
                             normalize_x, normalize_y)
from ..parallel.mesh import MODEL_PARALLEL, Mesh, data_mesh, sum_gradients
from .metrics import MetricSums, metric_sums_init, metric_sums_update
from .optim import Optimizer, all_finite

_MULTI_STEP = ("make_multi_train_step (K steps per dispatch, a lax.scan in "
               "the JAX package) is not ported to unet_convlstm_tpu_torch "
               "yet (ROADMAP.md, queue A item 7c)")


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
    return all_finite(opt.grads())


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
        x = normalize_x(x_raw, norm_stats)
        y = normalize_y(y_raw, norm_stats)
        mask = compute_mask(x_raw, norm_stats)
        opt.zero_grad()
        y_pred, _, new_bn = apply_fn(model, x, train=True)
        loss = compute_loss(y_pred, y, mask, use_mask,
                            grad_weight=grad_weight, mesh=mesh)
        loss.backward()
        sum_gradients(opt.grads(), mesh)
        opt.step()
        if not guard_nonfinite_stats or _update_was_finite(opt):
            commit_bn_stats(model, new_bn)
        sums = _sums(metric_sums_init(x_raw.device), y_pred, y, mask,
                     use_mask, norm_stats)
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
        snap = ([t.clone() for t in bn_buffers(model)]
                if guard_nonfinite_stats else None)
        opt.zero_grad()
        loss_sum = torch.zeros((), dtype=torch.float32, device=x_raw.device)
        sums = metric_sums_init(x_raw.device)
        for k in range(K):
            x_r, y_r = x_raw[k::K], y_raw[k::K]
            x = normalize_x(x_r, norm_stats)
            y = normalize_y(y_r, norm_stats)
            mask = compute_mask(x_r, norm_stats)
            y_pred, _, new_bn = apply_fn(model, x, train=True)
            loss = compute_loss(y_pred, y, mask, use_mask,
                                grad_weight=grad_weight, mesh=mesh)
            loss.backward()           # sums into .grad
            commit_bn_stats(model, new_bn)
            loss_sum = loss_sum + loss.detach().float()
            sums = _sums(sums, y_pred, y, mask, use_mask, norm_stats)
        grads = opt.grads()
        if grads:
            torch._foreach_div_(grads, float(K))
        sum_gradients(grads, mesh)
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
    splits the moments over it). ``state_sharding`` (tensor-parallel
    training) raises NotImplementedError (item 7b)."""
    if state_sharding is not None:
        raise NotImplementedError(MODEL_PARALLEL)
    mesh = data_mesh(mesh)
    if mesh is not None:
        apply_fn = functools.partial(apply_fn, mesh=mesh)
    if accum_steps > 1:
        return _make_accum_step_core(apply_fn, norm_stats, use_mask,
                                     grad_weight, accum_steps,
                                     guard_nonfinite_stats, mesh)
    return _make_step_core(apply_fn, norm_stats, use_mask, grad_weight,
                           guard_nonfinite_stats, mesh)


def make_multi_train_step(*args, **kwargs):
    """K steps per dispatch (a ``lax.scan`` in the JAX package): not
    ported."""
    raise NotImplementedError(_MULTI_STEP)


def make_eval_step(apply_fn: Callable, norm_stats: NormStats,
                   use_mask: bool = False, grad_weight: float = 0.005,
                   mesh=None, variables_sharding=None):
    """(model, x_raw, y_raw, n_valid) → (loss, sums), eval mode.

    ``n_valid``: the number of real rows; the rest are padding that keeps a
    tail batch at full size, and they carry zero weight. ``mesh``: x_raw
    and y_raw are this rank's rows of the global batch, ``n_valid`` counts
    the global batch's real rows, and the loss and sums are the global
    batch's. ``variables_sharding`` (tensor parallel) raises
    NotImplementedError (item 7b)."""
    if variables_sharding is not None:
        raise NotImplementedError(MODEL_PARALLEL)
    mesh = data_mesh(mesh)

    @torch.inference_mode()
    def step(model, x_raw: torch.Tensor, y_raw: torch.Tensor,
             n_valid: int) -> Tuple[torch.Tensor, MetricSums]:
        B = x_raw.shape[0]
        row0 = mesh.rank * B if mesh is not None else 0
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

    return step

