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

Under the FP32 policy the forward's convolutions run at full f32, but
autograd runs the library convolutions' backward after the forward has
left the policy's context, under torch's global TF32 flags (cuDNN's is on
by default). For full-f32 gradients on the card, call the step inside
``core.dtypes.full_fp32()``.
"""

from __future__ import annotations

from typing import Callable, List, Tuple

import torch

from ..models.temporal_unet import commit_bn_stats, double_convs
from ..ops.losses import compute_loss
from ..ops.normalize import (NormStats, compute_mask, denormalize_y,
                             normalize_x, normalize_y)
from .metrics import MetricSums, metric_sums_init, metric_sums_update
from .optim import Optimizer, all_finite

_MULTI_DEVICE = ("multi-device training is not ported to "
                 "unet_convlstm_tpu_torch yet (ROADMAP.md, queue A, "
                 "item 7: multi-device)")


def _update_was_finite(opt: Optimizer) -> bool:
    """The ``_guarded_bn`` rule: the optimizer's own verdict when it runs
    the non-finite skip (its count resets to 0 on a finite step, so the
    two never disagree), else the gradients' finiteness."""
    if opt.skip_nonfinite is not None:
        return opt.notfinite_count == 0
    return all_finite(opt.grads())


def _bn_buffers(model) -> List[torch.Tensor]:
    return [t for dc in double_convs(model).values() for bn in (dc.bn1, dc.bn2)
            for t in (bn.running_mean, bn.running_var)]


@torch.no_grad()
def _sums(acc: MetricSums, y_pred, y, mask, use_mask: bool,
          norm_stats: NormStats) -> MetricSums:
    return metric_sums_update(
        acc, denormalize_y(y_pred.float(), norm_stats),
        denormalize_y(y, norm_stats), mask, use_mask)


def _make_step_core(apply_fn: Callable, norm_stats: NormStats,
                    use_mask: bool, grad_weight: float,
                    guard_nonfinite_stats: bool = False):
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
                            grad_weight=grad_weight)
        loss.backward()
        opt.step()
        if not guard_nonfinite_stats or _update_was_finite(opt):
            commit_bn_stats(model, new_bn)
        sums = _sums(metric_sums_init(x_raw.device), y_pred, y, mask,
                     use_mask, norm_stats)
        return loss.detach(), sums

    return step


def _make_accum_step_core(apply_fn: Callable, norm_stats: NormStats,
                          use_mask: bool, grad_weight: float,
                          accum_steps: int,
                          guard_nonfinite_stats: bool = False):
    """Gradient accumulation: the [B] batch runs as ``accum_steps``
    microbatches, each differentiated at the SAME parameters; their mean
    gradient makes ONE optimizer update. Only one microbatch's activations
    are alive at a time. Microbatch k holds rows {k, k+K, k+2K, ...} (the
    JAX package's strided split). BatchNorm batch statistics are per
    microbatch and the running stats thread through them; a masked loss
    normalizes per microbatch, and the reported loss is their mean."""
    K = accum_steps

    def step(model, opt: Optimizer, x_raw: torch.Tensor,
             y_raw: torch.Tensor) -> Tuple[torch.Tensor, MetricSums]:
        B = x_raw.shape[0]
        if B % K:
            raise ValueError(
                f"batch size {B} is not divisible by accum_steps={K} — "
                f"gradient accumulation splits the batch into K equal "
                f"microbatches")
        snap = ([t.clone() for t in _bn_buffers(model)]
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
                                grad_weight=grad_weight)
            loss.backward()           # sums into .grad
            commit_bn_stats(model, new_bn)
            loss_sum = loss_sum + loss.detach().float()
            sums = _sums(sums, y_pred, y, mask, use_mask, norm_stats)
        grads = opt.grads()
        if grads:
            torch._foreach_div_(grads, float(K))
        opt.step()
        if guard_nonfinite_stats and not _update_was_finite(opt):
            with torch.no_grad():
                torch._foreach_copy_(_bn_buffers(model), snap)
        return loss_sum / K, sums

    return step


def make_train_step(apply_fn: Callable, norm_stats: NormStats,
                    use_mask: bool = False, grad_weight: float = 0.005,
                    mesh=None, state_sharding=None,
                    guard_nonfinite_stats: bool = False,
                    accum_steps: int = 1):
    """Build the step: (model, optimizer, x_raw, y_raw) → (loss, sums).

    ``accum_steps > 1``: gradient accumulation over that many microbatches
    of B/accum_steps rows before the single update. ``mesh`` and
    ``state_sharding`` (data- and tensor-parallel training) raise
    NotImplementedError."""
    if mesh is not None or state_sharding is not None:
        raise NotImplementedError(_MULTI_DEVICE)
    if accum_steps > 1:
        return _make_accum_step_core(apply_fn, norm_stats, use_mask,
                                     grad_weight, accum_steps,
                                     guard_nonfinite_stats)
    return _make_step_core(apply_fn, norm_stats, use_mask, grad_weight,
                           guard_nonfinite_stats)


def make_multi_train_step(*args, **kwargs):
    """K steps per dispatch (a ``lax.scan`` in the JAX package): not
    ported."""
    raise NotImplementedError(_MULTI_DEVICE + "; make_multi_train_step "
                              "comes with it")


def make_eval_step(apply_fn: Callable, norm_stats: NormStats,
                   use_mask: bool = False, grad_weight: float = 0.005,
                   mesh=None, variables_sharding=None):
    """(model, x_raw, y_raw, n_valid) → (loss, sums), eval mode.

    ``n_valid``: the number of real rows; the rest are padding that keeps a
    tail batch at full size, and they carry zero weight."""
    if mesh is not None or variables_sharding is not None:
        raise NotImplementedError(_MULTI_DEVICE)

    @torch.inference_mode()
    def step(model, x_raw: torch.Tensor, y_raw: torch.Tensor,
             n_valid: int) -> Tuple[torch.Tensor, MetricSums]:
        B = x_raw.shape[0]
        valid = (torch.arange(B, device=x_raw.device) < n_valid).float()
        x = normalize_x(x_raw, norm_stats)
        y = normalize_y(y_raw, norm_stats)
        mask = compute_mask(x_raw, norm_stats)
        y_pred, _, _ = apply_fn(model, x, train=False)
        loss = compute_loss(y_pred, y, mask, use_mask,
                            grad_weight=grad_weight, sample_weight=valid)
        vmask = valid.reshape((-1,) + (1,) * (y.dim() - 1))
        sums = _sums(metric_sums_init(x_raw.device), y_pred, y,
                     mask * vmask if use_mask else vmask, True, norm_stats)
        return loss, sums

    return step

