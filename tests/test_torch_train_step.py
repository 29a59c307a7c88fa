"""Three training steps of the port against the JAX package's train step:
the same weights (carried by ``state_dict_from_jax``), the same raw batch,
FP32 policy, both kernel flags on (Pallas in interpret mode on the JAX
side; the kernels' plain forward and backward on the port's).

base_ch 16, B=2, T=2, 16x16: the bottleneck cell has C = 256 and skip3
C = 128, so the JAX gate kernel and its VJP engage; skip2 (C = 64) takes
JAX's XLA chain against the port's kernel path."""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_convlstm_tpu.core.dtypes import FP32_POLICY as JFP32
from unet_convlstm_tpu.models import registry as jreg
from unet_convlstm_tpu.ops import losses as jlosses
from unet_convlstm_tpu.ops import normalize as jnorm
from unet_convlstm_tpu.train import optim as joptim
from unet_convlstm_tpu.train import steps as jsteps
from unet_convlstm_tpu_torch.core.dtypes import FP32_POLICY
from unet_convlstm_tpu_torch.models.registry import build_model
from unet_convlstm_tpu_torch.ops import losses as tlosses
from unet_convlstm_tpu_torch.ops import normalize as tnorm
from unet_convlstm_tpu_torch.ops.kernels import launch_counts, reset_launches
from unet_convlstm_tpu_torch.train import optim as toptim
from unet_convlstm_tpu_torch.train import steps as tsteps
from unet_convlstm_tpu_torch.utils.torch_weights import state_dict_from_jax

CFG = {"type": "custom", "base_ch": 16, "use_skip_lstm": True,
       "lstm_layers": 1}
B, T, HW = 2, 2, 16
LR = 1e-3
STEPS = 3
FLAGS = dict(use_pallas=True, use_fused_doubleconv=True)


def make_case(seed=0):
    """JAX variables with non-trivial BatchNorm affine parameters and
    running stats, and a raw batch with its norm stats (numpy)."""
    _, init, _, _ = jreg.build_model(CFG)
    v = jax.device_get(init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)

    def perturb(tree):
        for sub in tree.values():
            if isinstance(sub, dict) and {"scale", "bias"} <= set(sub):
                n = sub["scale"].shape[0]
                sub["scale"] = (rng.random(n) + 0.5).astype(np.float32)
                sub["bias"] = (rng.standard_normal(n) * 0.2).astype(
                    np.float32)
            elif isinstance(sub, dict) and {"mean", "var"} <= set(sub):
                n = sub["mean"].shape[0]
                sub["mean"] = (rng.standard_normal(n) * 0.1).astype(
                    np.float32)
                sub["var"] = (rng.random(n) * 0.5 + 0.2).astype(np.float32)
            elif isinstance(sub, dict):
                perturb(sub)

    perturb(v["params"])
    perturb(v["stats"])
    x = rng.gamma(2.0, 0.7, (B, T, HW, HW, 2)).astype(np.float32)
    y = (rng.standard_normal((B, T, HW, HW, 1)) * 3).astype(np.float32)
    return v, x, y, jnorm.compute_norm_stats(x, y)


def torch_model(v):
    _, init, apply, _ = build_model(CFG)
    model = init(device="cpu")
    model.load_state_dict(state_dict_from_jax(v), strict=True)
    return model, functools.partial(apply, policy=FP32_POLICY, **FLAGS)


def jax_apply():
    _, _, apply, _ = jreg.build_model(CFG)
    return functools.partial(apply, policy=JFP32, **FLAGS)


def assert_state_matches(model, jstate, lr=LR):
    """Params: RMS of (port - JAX) / lr ≤ 1e-2 (AdamW's first steps are
    sign-like, so a parameter moves about lr per step); BN running stats:
    1e-5."""
    ref = state_dict_from_jax({"params": jax.device_get(jstate["params"]),
                               "stats": jax.device_get(jstate["stats"])})
    ours = model.state_dict()
    diffs = []
    for name, p in model.named_parameters():
        diffs.append(((p.detach() - ref[name]) / lr).flatten())
    rms = float(torch.cat(diffs).pow(2).mean().sqrt())
    assert rms <= 1e-2, rms
    for name in ref:
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(ours[name].numpy(),
                                       ref[name].numpy(), rtol=1e-5,
                                       atol=1e-5, err_msg=name)


def assert_sums_close(st, sj):
    for a, b in zip(st, sj):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-4)


def load_jax_state(model, opt, jstate):
    """Put a JAX train state (params, BN running stats, AdamW moments and
    count) into the port's model and optimizer."""
    tree = lambda t: state_dict_from_jax(                     # noqa: E731
        {"params": jax.device_get(t), "stats": jax.device_get(
            jstate["stats"])})
    model.load_state_dict(tree(jstate["params"]), strict=True)
    adam = jstate["opt_state"][1].inner_state[0]    # clip, inject(adamw)
    opt.adamw.state.clear()
    if int(adam.count):
        mu, nu = tree(adam.mu), tree(adam.nu)
        for name, p in model.named_parameters():
            opt.adamw.state[p] = {"step": torch.tensor(float(adam.count)),
                                  "exp_avg": mu[name].clone(),
                                  "exp_avg_sq": nu[name].clone()}


@pytest.fixture(scope="module")
def runs():
    """Three steps, each started on both sides from the JAX state before
    it. Run freely, the two trajectories part: AdamW's first updates are
    about ±lr per element whatever the gradient's size, so an element whose
    gradient is at the f32 noise floor (a conv bias before train-mode BN,
    whose true gradient is 0) takes a noise-made sign: the JAX step
    parts from itself in three steps when its initial params are perturbed
    by 1e-7 relative. Each single step from the same state is held to
    1e-2 lr RMS."""
    v, x, y, stats = make_case()
    tx = joptim.make_optimizer(LR)
    jstate = {"params": v["params"], "stats": v["stats"],
              "opt_state": tx.init(v["params"])}
    jstep = jsteps.make_train_step(jax_apply(), tx, stats, use_mask=True,
                                   donate=False)
    model, apply = torch_model(v)
    opt = toptim.make_optimizer(model.named_parameters(), LR)
    tstep = tsteps.make_train_step(apply, stats, use_mask=True)
    out = []
    reset_launches()
    for _ in range(STEPS):
        load_jax_state(model, opt, jstate)
        tl, ts = tstep(model, opt, torch.from_numpy(x), torch.from_numpy(y))
        jstate, jl, js = jstep(jstate, jnp.asarray(x), jnp.asarray(y))
        out.append(dict(loss=(float(tl), float(jl)), sums=(ts, js),
                        state=(copy.deepcopy(model.state_dict()),
                               jax.device_get(jstate))))
    return dict(v=v, out=out, counts=launch_counts())


def test_losses_and_metric_sums_match_each_step(runs):
    for step in runs["out"]:
        tl, jl = step["loss"]
        np.testing.assert_allclose(tl, jl, rtol=1e-5)
        assert_sums_close(*step["sums"])
    # the loss moves: the steps did update the model
    assert runs["out"][0]["loss"][0] != runs["out"][-1]["loss"][0]
    assert not any(runs["counts"].values()), runs["counts"]  # CPU: none


def test_params_and_bn_stats_after_each_step(runs):
    model, _ = torch_model(runs["v"])
    for step in runs["out"]:
        ours, jstate = step["state"]
        model.load_state_dict(ours)
        assert_state_matches(model, jstate)
    # the running stats did move away from the init
    init = state_dict_from_jax(runs["v"])
    name = "inc.net.1.running_mean"
    assert not torch.allclose(ours[name], init[name])


def test_first_step_gradients_match_jax_grad():
    v, x, y, stats = make_case(1)
    xj, yj = jnp.asarray(x), jnp.asarray(y)
    mask = jnorm.compute_mask(xj, stats)
    apply_j = jax_apply()

    def loss_fn(params):
        y_pred, _, _ = apply_j({"params": params, "stats": v["stats"]},
                               jnorm.normalize_x(xj, stats), train=True)
        return jlosses.compute_loss(y_pred, jnorm.normalize_y(yj, stats),
                                    mask, True)

    g_j = state_dict_from_jax({"params": jax.device_get(
        jax.jit(jax.grad(loss_fn))(v["params"])), "stats": v["stats"]})

    model, apply = torch_model(v)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    y_pred, _, _ = apply(model, tnorm.normalize_x(xt, stats), train=True)
    tlosses.compute_loss(y_pred, tnorm.normalize_y(yt, stats),
                         tnorm.compute_mask(xt, stats), True).backward()
    norm = float(torch.cat([p.grad.flatten() for p in model.parameters()]
                           ).norm())
    assert norm > 0
    worst = max(float((p.grad - g_j[n]).abs().max())
                for n, p in model.named_parameters())
    assert worst <= 1e-4 * norm, (worst, norm)
