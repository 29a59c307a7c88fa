"""The three JAX keys of the port's model apply: ``flat_layout``, ``remat``
and ``unroll`` (models/layout.py, both families' apply, ``fit``).

* The layout functions bit-equal to the JAX package's for both layouts
  (they are reshapes and transposes), and an unknown layout refused.
* ``flat_layout`` per layout against the JAX apply from the same weights,
  both families, train and eval (tests/test_parallel.py's
  ``test_flat_layouts_agree`` set-up: B=3, T=2, 32x32, FP32): the outputs
  and the BatchNorm statistics within 1e-3 (the port-against-JAX bound of
  tests/test_torch_resnet_unet.py); and the port's two layouts against
  each other at the JAX test's own tolerances (train: outputs rtol 1e-4,
  atol 2e-4, statistics rtol 1e-4, atol 1e-5; eval: rtol 1e-6, atol
  1e-7): BatchNorm sums the frames in another order.
* ``remat`` against no remat (tests/test_dataset_and_train.py's
  ``test_remat_matches_no_remat_exactly``: base_ch 4 with the skip
  ConvLSTMs, B=2, T=3, 32x32, FP32, a squared-error loss): the loss, every
  gradient and the BatchNorm statistics bit-equal, with both kernel flags
  on (the kernels' plain versions recomputed here); the ResNet18 family
  with its encoder trained. The JAX remat loss is the oracle of both.
* ``unroll``: two values, the same bits.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_convlstm_tpu.core.dtypes import FP32_POLICY as JFP32
from unet_convlstm_tpu.models import layout as jlayout
from unet_convlstm_tpu.models import registry as jreg
from unet_convlstm_tpu_torch.core.dtypes import FP32_POLICY
from unet_convlstm_tpu_torch.models import layout
from unet_convlstm_tpu_torch.models.registry import build_model
from unet_convlstm_tpu_torch.utils.torch_weights import state_dict_from_jax

CUSTOM = {"type": "custom", "base_ch": 4, "use_skip_lstm": True,
          "lstm_layers": 1}
RESNET = {"type": "resnet18", "lstm_layers": 1, "freeze_encoder": False,
          "pretrained_resolved": True}
FAMILIES = {"custom": CUSTOM, "resnet": RESNET}
FLAGS = dict(use_pallas=True, use_fused_doubleconv=True)


def _jax_variables(cfg, seed=0):
    _, init, _, _ = jreg.build_model(dict(cfg))
    return jax.device_get(init(jax.random.PRNGKey(seed)))


def _port(cfg, v):
    _, init, apply, _ = build_model(dict(cfg))
    model = init(device="cpu")
    model.load_state_dict(state_dict_from_jax(v), strict=True)
    return model, apply


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _port_stats(model, stats):
    """The port's stats tree as [mean, var, ...] in bn_layers() order."""
    out = []
    for path in model.bn_layers():
        t = stats
        for key in path:
            t = t[key]
        out += [t[0].detach().numpy(), t[1].detach().numpy()]
    return out


def _jax_stats(model, stats):
    out = []
    for path in model.bn_layers():
        t = stats
        for key in path:
            t = t[key]
        out += [np.asarray(t["mean"]), np.asarray(t["var"])]
    return out


def test_layout_functions_match_jax():
    x = np.random.default_rng(0).standard_normal((3, 2, 4, 5, 6)).astype(
        np.float32)
    B, T = 3, 2
    for lay in layout.LAYOUTS:
        flat = layout.flatten_seq(torch.from_numpy(x), lay)
        jflat = jlayout.flatten_seq(jnp.asarray(x), lay)
        assert np.array_equal(flat.numpy(), np.asarray(jflat))
        tm = layout.to_time_major(flat, B, T, lay)
        assert np.array_equal(tm.numpy(), np.asarray(
            jlayout.to_time_major(jflat, B, T, lay)))
        back = layout.to_batch_major(tm, B, T, lay)
        assert np.array_equal(back.numpy(), flat.numpy())
        assert np.array_equal(layout.unflatten_seq(back, B, T, lay).numpy(),
                              x)
    for fn, args in ((layout.flatten_seq, ()),
                     (layout.unflatten_seq, (B, T)),
                     (layout.to_time_major, (B, T)),
                     (layout.to_batch_major, (B, T))):
        with pytest.raises(ValueError, match="unknown flat layout"):
            fn(torch.from_numpy(x), *args, "rows")


@pytest.mark.parametrize("family", list(FAMILIES))
def test_flat_layouts_match_jax_and_agree(family):
    cfg = FAMILIES[family]
    v = _jax_variables(cfg)
    _, _, japply, _ = jreg.build_model(dict(cfg))
    model, apply = _port(cfg, v)
    x = np.random.default_rng(0).standard_normal((3, 2, 32, 32, 2)).astype(
        np.float32)
    for train in (False, True):
        got = {}
        for lay in layout.LAYOUTS:
            with torch.no_grad():
                y, _, bn = apply(model, torch.from_numpy(x), train=train,
                                 policy=FP32_POLICY, flat_layout=lay)
            jy, _, jbn = japply(v, jnp.asarray(x), train=train,
                                policy=JFP32, flat_layout=lay)
            np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-3,
                                       atol=1e-3, err_msg=f"{lay} {train}")
            stats = _port_stats(model, bn)
            for a, b in zip(stats, _jax_stats(model, jbn)):
                np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-3)
            got[lay] = (y.numpy(), stats)
        (yt, st), (yb, sb) = got["time"], got["batch"]
        tol = (dict(rtol=1e-4, atol=2e-4) if train
               else dict(rtol=1e-6, atol=1e-7))
        np.testing.assert_allclose(yt, yb, **tol)
        for a, b in zip(st, sb):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


def _loss_and_grads(model, apply, x, y, **kw):
    model.zero_grad()
    out, _, bn = apply(model, x, train=True, policy=FP32_POLICY, **kw)
    loss = ((out - y) ** 2).mean()
    loss.backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()
             if p.grad is not None}
    return loss.detach(), grads, [t.detach() for t in _leaves(bn)]


@pytest.mark.parametrize("family", list(FAMILIES))
def test_remat_matches_no_remat(family):
    cfg = FAMILIES[family]
    v = _jax_variables(cfg)
    model, apply = _port(cfg, v)
    side = 32 if family == "custom" else 64
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.uniform(size=(2, 3, side, side, 2))
                         .astype(np.float32))
    y = torch.from_numpy(rng.standard_normal((2, 3, side, side, 1))
                         .astype(np.float32))
    flags = FLAGS if family == "custom" else dict(use_pallas=True)
    l0, g0, s0 = _loss_and_grads(model, apply, x, y, **flags)
    l1, g1, s1 = _loss_and_grads(model, apply, x, y, remat=True, **flags)
    assert torch.equal(l0, l1)
    assert set(g0) == set(g1) and len(g0) == len(list(model.parameters()))
    for n in g0:
        assert torch.equal(g0[n], g1[n]), n
    assert len(s0) == len(s1) > 0
    assert all(torch.equal(a, b) for a, b in zip(s0, s1))
    # the JAX remat loss from the same weights
    _, _, japply, _ = jreg.build_model(dict(cfg))
    jout, _, _ = japply(v, jnp.asarray(x.numpy()), train=True, policy=JFP32,
                        remat=True)
    jl = float(jnp.mean((jout - jnp.asarray(y.numpy())) ** 2))
    np.testing.assert_allclose(float(l1), jl, rtol=1e-4)


def test_unroll_gives_the_same_bits():
    v = _jax_variables(CUSTOM)
    model, apply = _port(CUSTOM, v)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 3, 32, 32, 2)).astype(np.float32))
    run = functools.partial(apply, model, x, train=True, policy=FP32_POLICY,
                            **FLAGS)
    with torch.no_grad():
        a, sa, ba = run(unroll=1)
        b, sb, bb = run(unroll=10)
    assert torch.equal(a, b)
    for p, q in zip(_leaves(sa) + _leaves(ba), _leaves(sb) + _leaves(bb)):
        assert torch.equal(p, q)
