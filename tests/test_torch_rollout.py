"""The three rollouts (streaming, whole sequence, prefix re-runs): the
port's eval/rollout.py against the JAX package's, for both model
families, FP32 policy (Pallas in interpret mode on the JAX side, the
kernels' plain versions on the port's), and streaming against the whole
sequence inside the port.

Tolerances: 1e-3 relative (of max |y|) against JAX, the full model's;
within the port, streaming and the whole-sequence rollout compute the same
sums on the CPU batched differently: 1e-5 relative, and the final states
agree to 1e-5 with the same dtypes (h in the compute dtype, c in f32)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_convlstm_tpu.core.dtypes import FP32_POLICY as JFP32
from unet_convlstm_tpu.eval import rollout as jr
from unet_convlstm_tpu.models.resnet_unet import (
    ResNetUNetConfig as JResConfig, resnet_unet_apply as j_res_apply,
    resnet_unet_init, resnet_unet_init_state as j_res_state)
from unet_convlstm_tpu.models.temporal_unet import (
    TemporalUNetConfig as JConfig, temporal_unet_apply as j_apply,
    temporal_unet_init, temporal_unet_init_state as j_state)
from unet_convlstm_tpu_torch.core.dtypes import FP32_POLICY
from unet_convlstm_tpu_torch.eval import (rollout_prefix_rerun, rollout_scan,
                                          rollout_streaming)
from unet_convlstm_tpu_torch.models.resnet_unet import (
    PretrainedTemporalUNet, ResNetUNetConfig, resnet_unet_apply,
    resnet_unet_init_state)
from unet_convlstm_tpu_torch.models.temporal_unet import (
    TemporalUNetConfig, TemporalUNetDualView, temporal_unet_apply,
    temporal_unet_init_state)
from unet_convlstm_tpu_torch.utils.torch_weights import state_dict_from_jax

CFG = dict(base_ch=4, use_skip_lstm=True, lstm_layers=1)


def _custom():
    v = jax.device_get(temporal_unet_init(jax.random.PRNGKey(0),
                                          JConfig(**CFG)))
    j_fn = functools.partial(j_apply, cfg=JConfig(**CFG), policy=JFP32,
                             use_pallas=True)
    m = TemporalUNetDualView(TemporalUNetConfig(**CFG))
    m.load_state_dict(state_dict_from_jax(v), strict=True)
    t_fn = functools.partial(temporal_unet_apply, policy=FP32_POLICY,
                             use_pallas=True, use_fused_doubleconv=True)
    return (v, lambda v_, x, state=None, train=False: j_fn(
        v_, x, state=state, train=train),
        lambda b, h, w: j_state(JConfig(**CFG), b, h, w),
        m.eval(), t_fn,
        lambda b, h, w, device=None: temporal_unet_init_state(
            TemporalUNetConfig(**CFG), b, h, w, device=device), 2, 3)


def _resnet():
    cfg = dict(lstm_layers=1)
    v = jax.device_get(jax.jit(resnet_unet_init, static_argnums=1)(
        jax.random.PRNGKey(1), JResConfig(**cfg)))
    j_fn = functools.partial(j_res_apply, cfg=JResConfig(**cfg),
                             policy=JFP32, use_pallas=True)
    m = PretrainedTemporalUNet(ResNetUNetConfig(**cfg))
    m.load_state_dict(state_dict_from_jax(v), strict=True)
    t_fn = functools.partial(resnet_unet_apply, policy=FP32_POLICY,
                             use_pallas=True)
    return (v, lambda v_, x, state=None, train=False: j_fn(
        v_, x, state=state, train=train),
        lambda b, h, w: j_res_state(JResConfig(**cfg), b, h, w),
        m.eval(), t_fn,
        lambda b, h, w, device=None: resnet_unet_init_state(
            ResNetUNetConfig(**cfg), b, h, w, device=device), 1, 2)


@pytest.fixture(scope="module", params=["custom", "resnet"])
def family(request):
    return (_custom if request.param == "custom" else _resnet)()


def _frames(B, T):
    return np.random.default_rng(5).random((B, T, 32, 32, 2)).astype(
        np.float32)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-12))


def _leaves(state):
    return [t for k in sorted(state) for hc in state[k] for t in hc]


def test_rollouts_match_jax(family):
    v, j_fn, j_init, m, t_fn, t_init, B, T = family
    x = _frames(B, T)
    xt = torch.from_numpy(x)
    y_j, s_j = jr.rollout_streaming(j_fn, v, jnp.asarray(x), j_init)
    y_t, s_t = rollout_streaming(t_fn, m, xt, t_init)
    assert y_t.shape == y_j.shape and _rel(y_t, y_j) < 1e-3
    for a, b in zip(_leaves(s_t), _leaves(s_j)):
        assert _rel(a, b) < 1e-3
    y_js, _ = jr.rollout_scan(j_fn, v, jnp.asarray(x), j_init)
    y_ts, s_ts = rollout_scan(t_fn, m, xt, t_init)
    assert _rel(y_ts, y_js) < 1e-3
    p_j = jr.rollout_prefix_rerun(j_fn, v, jnp.asarray(x))
    p_t = rollout_prefix_rerun(t_fn, m, xt)
    assert len(p_t) == len(p_j) == T
    for a, b in zip(p_t, p_j):
        assert a.shape == b.shape and _rel(a, b) < 1e-3
    # the last prefix is the whole sequence from zero state: its last
    # frame is the streaming rollout's
    assert _rel(p_t[-1], y_t[:, -1]) < 1e-5


def test_streaming_equals_whole_sequence(family):
    _, _, _, m, t_fn, t_init, B, T = family
    xt = torch.from_numpy(_frames(B, T))
    y_s, s_s = rollout_streaming(t_fn, m, xt, t_init)
    y_w, s_w = rollout_scan(t_fn, m, xt, t_init)
    assert _rel(y_w, y_s) < 1e-5
    for a, b in zip(_leaves(s_w), _leaves(s_s)):
        assert a.dtype == b.dtype and _rel(a, b) < 1e-5
    # continued from a carried state: split the sequence in two
    y_a, s_a = rollout_scan(t_fn, m, xt[:, :1], t_init)
    y_b, _ = rollout_scan(t_fn, m, xt[:, 1:], t_init, state=s_a)
    assert _rel(torch.cat([y_a, y_b], 1), y_s) < 1e-5


def test_multi_device_rollout_raises():
    """A mesh that is no parallel.Mesh raises; data parallelism runs
    (test_torch_parallel.py)."""
    with pytest.raises(TypeError, match="parallel.Mesh"):
        rollout_scan(None, None, torch.zeros(1, 1, 2, 2, 1), None,
                     mesh=object())
