"""The FP32 policy's backward runs its library convolutions with TF32 off,
as its forward does.

Autograd runs a convolution's backward after the forward has left the
policy's ``precision()`` context, so without the port's own hooks it would
run under torch's global flags: with cuDNN's TF32 on (torch's default), a
trainer under the FP32 policy would compute TF32 gradients on the card
where the JAX package computes f32 ones. A pre-hook on every library
convolution's backward node records cuDNN's TF32 flag as that backward
starts, with the flag forced on around the step. The flags are global, so
this holds on the CPU as on the card."""

import functools

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from unet_convlstm_tpu_torch.core.dtypes import DEFAULT_POLICY, FP32_POLICY
from unet_convlstm_tpu_torch.models.registry import build_model
from unet_convlstm_tpu_torch.ops import conv
from unet_convlstm_tpu_torch.ops.normalize import compute_norm_stats
from unet_convlstm_tpu_torch.train.optim import make_optimizer
from unet_convlstm_tpu_torch.train.steps import make_train_step

CFG = {"type": "custom", "base_ch": 4, "use_skip_lstm": True,
       "lstm_layers": 1}


def _recording(fn, seen):
    """``fn`` (a torch conv) whose output's backward node records cuDNN's
    TF32 flag at the moment it runs."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        y = fn(*args, **kwargs)
        if y.grad_fn is not None:
            y.grad_fn.register_prehook(
                lambda grads: seen.append(torch.backends.cudnn.allow_tf32))
        return y

    return wrapped


@pytest.mark.parametrize("policy,expect", [(FP32_POLICY, False),
                                           (DEFAULT_POLICY, True)],
                         ids=["fp32", "bf16"])
def test_train_step_conv_backward_tf32_flag(monkeypatch, policy, expect):
    seen = []
    monkeypatch.setattr(conv.F, "conv2d", _recording(F.conv2d, seen))
    monkeypatch.setattr(conv.F, "conv_transpose2d",
                        _recording(F.conv_transpose2d, seen))
    rng = np.random.default_rng(0)
    x = rng.gamma(2.0, 0.7, (1, 2, 16, 16, 2)).astype(np.float32)
    y = rng.standard_normal((1, 2, 16, 16, 1)).astype(np.float32)
    _, init, apply, _ = build_model(CFG)
    model = init(torch.Generator().manual_seed(0), device="cpu")
    step = make_train_step(
        functools.partial(apply, policy=policy, use_pallas=True,
                          use_fused_doubleconv=True),
        compute_norm_stats(x, y))
    opt = make_optimizer(model.named_parameters(), 1e-3)
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        loss, _ = step(model, opt, torch.from_numpy(x), torch.from_numpy(y))
        after = torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    assert torch.isfinite(loss)
    # inc conv1, the ConvLSTM gate convs, the up-convs and outc at least
    assert len(seen) >= 8
    assert set(seen) == {expect}
    assert after is True          # the caller's flag, restored
