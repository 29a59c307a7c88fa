"""Per-op parity of the PyTorch port (unet_convlstm_tpu_torch/ops) with the
JAX package: the same numpy inputs through both, FP32 policy, at 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_convlstm_tpu.core.dtypes import FP32_POLICY as JFP32
from unet_convlstm_tpu.models import layout as jlayout
from unet_convlstm_tpu.ops import conv as jconv
from unet_convlstm_tpu.ops import normalize as jnorm
from unet_convlstm_tpu_torch.core.dtypes import FP32_POLICY, Policy
from unet_convlstm_tpu_torch.models import layout as tlayout
from unet_convlstm_tpu_torch.ops import conv as tconv
from unet_convlstm_tpu_torch.ops import normalize as tnorm

TOL = dict(rtol=1e-5, atol=1e-5)


def _oihw(w_hwio):
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(w_hwio, (3, 2, 0, 1))))


@pytest.mark.parametrize("k,stride,padding", [
    (3, 1, "SAME"), (3, 2, "SAME"), (1, 1, "SAME"), (3, 1, "VALID"),
    (3, 1, [(1, 2), (0, 1)]), (7, 1, "SAME"),
])
def test_conv2d(k, stride, padding):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, 10, 5)).astype(np.float32)
    w = rng.standard_normal((k, k, 5, 6)).astype(np.float32) * 0.2
    b = rng.standard_normal(6).astype(np.float32)
    yj = jconv.conv2d({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                      jnp.asarray(x), stride=stride, padding=padding,
                      policy=JFP32)
    yt = tconv.conv2d(torch.from_numpy(x), _oihw(w), torch.from_numpy(b),
                      stride=stride, padding=padding, policy=FP32_POLICY)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)


def test_conv_transpose2d():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 6, 8)).astype(np.float32)
    wt = rng.standard_normal((2, 2, 4, 8)).astype(np.float32) * 0.3  # HWOI
    b = rng.standard_normal(4).astype(np.float32)
    yj = jconv.conv_transpose2d({"wt": jnp.asarray(wt), "b": jnp.asarray(b)},
                                jnp.asarray(x), policy=JFP32)
    # the torch weight is wt.transpose(3, 2, 0, 1): (in, out, kh, kw)
    yt = tconv.conv_transpose2d(torch.from_numpy(x), _oihw(wt),
                                torch.from_numpy(b), policy=FP32_POLICY)
    assert yt.shape == (2, 10, 12, 4)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)


def test_max_pool2d():
    x = np.random.default_rng(2).standard_normal((2, 8, 6, 3)).astype(
        np.float32)
    np.testing.assert_array_equal(
        tconv.max_pool2d(torch.from_numpy(x), 2).numpy(),
        np.asarray(jconv.max_pool2d(jnp.asarray(x), 2)))


def _bn_pair(rng, c):
    scale = (rng.random(c) + 0.5).astype(np.float32)
    bias = rng.standard_normal(c).astype(np.float32) * 0.3
    mean = rng.standard_normal(c).astype(np.float32) * 0.2
    var = (rng.random(c) + 0.5).astype(np.float32)
    bn = torch.nn.BatchNorm2d(c)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.running_mean.copy_(torch.from_numpy(mean))
        bn.running_var.copy_(torch.from_numpy(var))
    params = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    stats = {"mean": jnp.asarray(mean), "var": jnp.asarray(var)}
    return bn, params, stats


@pytest.mark.parametrize("train", [False, True])
def test_batchnorm(train):
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((3, 5, 4, 6)) * 2 + 1).astype(np.float32)
    bn, params, stats = _bn_pair(rng, 6)
    yj, sj = jconv.batchnorm(params, stats, jnp.asarray(x), train)
    with torch.no_grad():
        yt, (mean, var) = tconv.batchnorm(bn, torch.from_numpy(x), train)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)
    np.testing.assert_allclose(mean.numpy(), np.asarray(sj["mean"]), **TOL)
    np.testing.assert_allclose(var.numpy(), np.asarray(sj["var"]), **TOL)


@pytest.mark.parametrize("train", [False, True])
def test_batchnorm_from_sums(train):
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((3, 5, 4, 6)) * 2 + 1).astype(np.float32)
    bn, params, stats = _bn_pair(rng, 6)
    s, q = x.sum((0, 1, 2)), (x * x).sum((0, 1, 2))
    ij, hj, sj = jconv.batchnorm_from_sums(params, stats, jnp.asarray(s),
                                           jnp.asarray(q), 60, train)
    with torch.no_grad():
        it, ht, (mean, var) = tconv.batchnorm_from_sums(
            bn, torch.from_numpy(s), torch.from_numpy(q), 60, train)
    for a, b in ((it, ij), (ht, hj), (mean, sj["mean"]), (var, sj["var"])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)



class _CountOps(torch.utils._python_dispatch.TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(func.__name__)
        return func(*args, **(kwargs or {}))


def _fresh_affine(bn, dtype):
    inv = torch.rsqrt(bn.running_var + 1e-5) * bn.weight
    return inv.to(dtype), (bn.bias - bn.running_mean * inv).to(dtype)


def _change_in_place(bn):
    with torch.no_grad():
        bn.running_var.mul_(2.0)


def _change_by_state_dict(bn):
    sd = {k: v.clone() for k, v in bn.state_dict().items()}
    sd["weight"] = sd["weight"] * 3.0
    bn.load_state_dict(sd)


def _change_by_data(bn):
    bn.bias.data = bn.bias.data + 1.0


def _change_by_new_buffer(bn):
    bn.running_mean = bn.running_mean - 0.5


@pytest.mark.parametrize("change", [_change_in_place, _change_by_state_dict,
                                    _change_by_data, _change_by_new_buffer],
                         ids=["in_place", "load_state_dict", "data",
                              "new_buffer"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_eval_affine_kept_until_the_weights_change(change, dtype):
    """With gradients off, eval-mode BatchNorm's (inv, shift) are computed
    once and reused; any change to the weights or running statistics
    computes them afresh, bit-equal to the formula."""
    rng = np.random.default_rng(5)
    bn, _, _ = _bn_pair(rng, 6)
    x = torch.from_numpy(rng.standard_normal((2, 3, 4, 6)).astype(
        np.float32)).to(dtype)
    with torch.no_grad():
        first = tconv.eval_affine(bn, dtype)
        assert tconv.eval_affine(bn, dtype) is first
        y_kept, _ = tconv.batchnorm(bn, x, False)
        change(bn)
        again = tconv.eval_affine(bn, dtype)
        assert again is not first
        for a, b in zip(again, _fresh_affine(bn, dtype)):
            assert torch.equal(a, b)
        y_new, _ = tconv.batchnorm(bn, x, False)
    inv, shift = _fresh_affine(bn, dtype)
    assert torch.equal(y_new, x * inv + shift)
    assert not torch.equal(y_new, y_kept)


@pytest.mark.parametrize("inference", [False, True])
def test_eval_batchnorm_launches_two_ops_once_kept(inference):
    """A kept affine leaves the normalization's multiply and add: two ops
    where the affine's recomputation and casts took nine."""
    rng = np.random.default_rng(6)
    bn, _, _ = _bn_pair(rng, 6)
    x = torch.randn(2, 3, 4, 6, dtype=torch.bfloat16)
    with (torch.inference_mode() if inference else torch.no_grad()):
        tconv.batchnorm(bn, x, False)
        with _CountOps() as counted:
            tconv.batchnorm(bn, x, False)
    assert counted.ops == ["mul.Tensor", "add.Tensor"]


def test_eval_affine_with_gradients_reaches_the_weights():
    """With gradients on, the affine is computed each call, so the
    weights take their gradient."""
    rng = np.random.default_rng(7)
    bn, _, _ = _bn_pair(rng, 6)
    x = torch.randn(2, 3, 4, 6)
    assert tconv.eval_affine(bn, x.dtype) is not tconv.eval_affine(
        bn, x.dtype)
    y, _ = tconv.batchnorm(bn, x, False)
    y.sum().backward()
    assert bn.weight.grad is not None and bn.weight.grad.abs().sum() > 0
    assert bn.bias.grad is not None


def _change_twice(bn):
    # the first replacement is freed by the second, whose tensor may take
    # its address at the same version
    bn.running_mean = bn.running_mean - 0.5
    bn.running_mean = bn.running_mean - 0.5


def test_eval_affine_after_two_new_buffers():
    rng = np.random.default_rng(8)
    bn, _, _ = _bn_pair(rng, 6)
    with torch.no_grad():
        tconv.eval_affine(bn, torch.float32)
        _change_twice(bn)
        got = tconv.eval_affine(bn, torch.float32)
    for a, b in zip(got, _fresh_affine(bn, torch.float32)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_cast_param_kept_until_the_weight_changes(dtype):
    """With gradients off a parameter's cast is made once; an in-place
    update (an optimizer step) or a new ``.data`` makes it afresh."""
    policy = Policy(compute_dtype=dtype)
    conv = tconv.Conv2d(3, 4, 3, generator=torch.Generator().manual_seed(0))
    opt = torch.optim.SGD(conv.parameters(), lr=0.5)
    with torch.no_grad():
        first = policy.cast_param(conv.weight)
        assert policy.cast_param(conv.weight) is first
        assert torch.equal(first, conv.weight.to(dtype))
    x = torch.randn(2, 5, 5, 3)
    tconv.conv2d(x, conv, policy=FP32_POLICY).sum().backward()
    opt.step()
    with torch.no_grad():
        stepped = policy.cast_param(conv.weight)
        assert stepped is not first
        assert torch.equal(stepped, conv.weight.to(dtype))
        conv.weight.data = conv.weight.data * 2.0
        assert torch.equal(policy.cast_param(conv.weight),
                           conv.weight.to(dtype))
        assert policy.cast_param(conv.bias) is policy.cast_param(conv.bias)


def test_cast_param_with_gradients_is_made_each_call():
    conv = tconv.Conv2d(3, 4, 3, generator=torch.Generator().manual_seed(1))
    policy = Policy(compute_dtype=torch.bfloat16)
    a, b = policy.cast_param(conv.weight), policy.cast_param(conv.weight)
    assert a is not b and a.grad_fn is not None
    (a.float().sum() + b.float().sum()).backward()
    assert torch.equal(conv.weight.grad, torch.full_like(conv.weight, 2.0))


def test_kept_holds_nothing_alive():
    """A kept value keeps neither its owner nor its tensors alive."""
    import gc
    import weakref

    conv = tconv.Conv2d(3, 4, 3, generator=torch.Generator().manual_seed(2))
    bn = torch.nn.BatchNorm2d(4).eval()
    with torch.no_grad():
        Policy().cast_param(conv.weight)
        tconv.eval_affine(bn, torch.bfloat16)
    refs = [weakref.ref(conv.weight), weakref.ref(bn),
            weakref.ref(bn.running_var)]
    del conv, bn
    gc.collect()
    assert all(r() is None for r in refs)

def test_time_major_flatten():
    x = np.arange(2 * 3 * 2 * 2 * 1, dtype=np.float32).reshape(2, 3, 2, 2, 1)
    flat_t = tlayout.flatten_seq(torch.from_numpy(x))
    flat_j = jlayout.flatten_seq(jnp.asarray(x), "time")
    np.testing.assert_array_equal(flat_t.numpy(), np.asarray(flat_j))
    tm_t = tlayout.to_time_major(flat_t, 2, 3)
    np.testing.assert_array_equal(
        tm_t.numpy(), np.asarray(jlayout.to_time_major(flat_j, 2, 3, "time")))
    np.testing.assert_array_equal(
        tlayout.to_batch_major(tm_t, 2, 3).numpy(), flat_t.numpy())
    np.testing.assert_array_equal(
        tlayout.unflatten_seq(flat_t, 2, 3).numpy(), x)


@pytest.mark.parametrize("transform", ["asinh", "signed_log", "none"])
def test_norm_stats_and_transforms(transform):
    rng = np.random.default_rng(5)
    X = rng.random((4, 3, 8, 8, 2)).astype(np.float32) * 3
    Y = (rng.standard_normal((4, 3, 8, 8, 1)) * 5).astype(np.float32)
    st = tnorm.compute_norm_stats(X, Y, y_transform=transform)
    sj = jnorm.compute_norm_stats(X, Y, y_transform=transform)
    assert st.to_dict() == sj.to_dict()
    np.testing.assert_allclose(
        tnorm.normalize_x(torch.from_numpy(X), st).numpy(),
        np.asarray(jnorm.normalize_x(jnp.asarray(X), sj)), **TOL)
    yn = np.clip(Y / 10, -1, 1).astype(np.float32)
    np.testing.assert_allclose(
        tnorm.denormalize_y(torch.from_numpy(yn), st).numpy(),
        np.asarray(jnorm.denormalize_y(jnp.asarray(yn), sj)),
        rtol=1e-5, atol=1e-4)
