"""Data parallelism of the port (``parallel/mesh.py``; the data-parallel
train and eval steps, ZeRO-1, ``evaluate_model`` and ``rollout_scan`` with a
mesh, ``fit`` with ``mesh_data``) against the JAX package on its 8-device
virtual CPU mesh (``tests/test_parallel.py`` holds the JAX side's own
checks), and against the port in one process.

The port's ranks are CPU processes spawned over gloo by
``run_local_ranks`` (``tests/_torch_ranks.py``): each group has a 60 s
collective timeout and each run a wall-clock limit, so a rank that dies
fails the test instead of hanging the suite. Everything runs in f32 (the FP32 policies) at base_ch
4, T=2, 16x16 or 32x32. The JAX package reaches no Pallas kernel here (its flags
off); the port's kernel flags are on, so its fused DoubleConv (K2's plain
version on the CPU) feeds BatchNorm through ``batchnorm_from_sums``.

Tolerances, with their reasons:
* gradients of one data-parallel step against JAX's single-device ones:
  rtol 1e-5 (the JAX test's); the ranks' sums add in another order;
* three train steps at D ranks against one process of the port on the
  global batch: losses rtol 2e-5, parameters and BatchNorm running
  statistics rtol 1e-4 (atol 1e-5: an element of the L1 loss's sign(d)
  gradient may flip between two orders of the same sums, which moves a
  first-conv weight by a few 1e-6 after three steps); against JAX's
  data-parallel step: losses rtol 2e-5, running statistics rtol 1e-4 (atol
  1e-5, as test_torch_train_step.py), the first step's parameter change
  (-lr times the gradient) elementwise within 1e-4 of its norm
  (test_torch_train_step.py's gradient bound), and the change over three
  steps within 2e-2 of its norm (relative L2 over all parameters: steps 2
  and 3 start from parameters that already differ, and the masked loss
  parts fastest, 6e-3 after three steps here). The ResNet18 case runs one
  step: its random decoder's BatchNorm is so ill-conditioned in f32 that
  two orders of the same sums part the loss beyond 2e-5 by the third
  step, while in float64 the data-parallel and one-process gradients agree
  to rounding. The custom model runs at 16x16 here: at 32x32 with B=8 the
  JAX package's f32 gradients on the CPU already stand far from a float64
  evaluation of the same function (the port's do not), which would swamp
  the comparison. The optimizer is momentum SGD (the port's Optimizer with
  its AdamW swapped for ``torch.optim.SGD``, clip off), as the JAX
  package's own ZeRO-1 test does: AdamW's first updates are about +-lr
  whatever |g| is, so an element whose gradient lies at the f32 noise floor
  (a conv bias before train-mode BatchNorm, whose true gradient is 0) takes
  a noise-made sign, and two correct implementations part by 2 lr there;
* ZeRO-1 against replicated data parallelism in the port: bit-equal (the
  slice update is the same elementwise AdamW arithmetic);
* ``evaluate_model`` and ``rollout_scan`` at D=2 against one process of
  the port: the JAX test's tolerances (rtol 1e-5, histograms equal, the
  sorted scatter pool 1e-6); against JAX's single-device results: the
  port-against-JAX tolerances of test_torch_eval_metrics.py and
  test_torch_rollout.py (scalars 1e-3, gt_hist equal, pred_hist within
  0.1% of the pixels in L1; the rollout 1e-3 relative L2);
* ``fit`` at mesh_data=2 against one process, both under the FP32
  policy: the history within 1e-3 relative, the checkpoints' model state
  within 1e-3 in relative L2 (AdamW moves an element by about lr whatever
  its gradient, so the noise-floor elements part by up to 2 lr a step, and
  in eval mode a conv bias before BatchNorm shifts the output);
  with and without ZeRO-1 bit-equal to each other. (Under the default bf16
  policy the rounding unit is 3.9e-3, and one bf16 ulp of an activation
  flips the sign of many small gradients.)

The rank functions below import no JAX: a spawned rank imports this module
to find them.
"""

import functools
import os

import numpy as np
import pytest
import torch

from unet_convlstm_tpu_torch.core.dtypes import FP32_POLICY
from unet_convlstm_tpu_torch.data.moving_mnist import save_moving_mnist_npz
from unet_convlstm_tpu_torch.data.npz_dataset import NPZSequenceDataset
from unet_convlstm_tpu_torch.eval.metrics import evaluate_model
from unet_convlstm_tpu_torch.eval.rollout import rollout_scan
from unet_convlstm_tpu_torch.models.registry import build_model
from unet_convlstm_tpu_torch.ops.conv import batchnorm, conv2d
from unet_convlstm_tpu_torch.ops.normalize import compute_norm_stats
from unet_convlstm_tpu_torch.parallel import (MeshRules, batch_sharding,
                                              make_mesh, replicated_sharding,
                                              shard_batch_spec)
from unet_convlstm_tpu_torch.parallel.mesh import Mesh, sum_gradients

from _torch_ranks import run_local_ranks, to_host
from unet_convlstm_tpu_torch.train import checkpoint as tckpt
from unet_convlstm_tpu_torch.train import loop as tloop
from unet_convlstm_tpu_torch.train.config import TrainConfig
from unet_convlstm_tpu_torch.train.loop import fit
from unet_convlstm_tpu_torch.train.optim import make_optimizer
from unet_convlstm_tpu_torch.train.steps import make_train_step

CFG = {"type": "custom", "base_ch": 4, "use_skip_lstm": True,
       "lstm_layers": 1}
# the production posture (configs/cloud_resnet.json): the encoder frozen,
# its BatchNorm in inference mode; the decoder's BatchNorm (ops.conv's
# unfused ``batchnorm``) trains. pretrained_resolved keeps the freeze
# without an ImageNet .pth (the test's weights stand for it)
RESNET_CFG = {"type": "resnet18", "lstm_layers": 1, "freeze_encoder": True,
              "pretrained_resolved": True}
FLAGS = dict(use_pallas=True, use_fused_doubleconv=True)
LR = 1e-2
# name: (model config, height and width, global batch, use_mask, accum,
# steps)
CASES = {
    "plain": (CFG, 16, 8, False, 1, 3),
    "masked": (CFG, 16, 8, True, 1, 3),
    "accum": (CFG, 16, 8, False, 2, 3),
    "resnet": (RESNET_CFG, 32, 4, True, 1, 1),
}
RUNS = {2: ("masked", "accum", "resnet"), 4: ("plain",)}


def _batch(seed, b, hw, t=2):
    rng = np.random.default_rng(seed)
    x = rng.gamma(2.0, 0.7, (b, t, hw, hw, 2)).astype(np.float32)
    y = (rng.standard_normal((b, t, hw, hw, 1)) * 3).astype(np.float32)
    return x, y


def _init_state(cfg, seed=0):
    _, init, _, _ = build_model(dict(cfg))
    model = init(torch.Generator().manual_seed(seed), device="cpu")
    return {k: v.numpy().copy() for k, v in model.state_dict().items()}


def _port_model(cfg, state, policy=FP32_POLICY):
    _, init, apply, _ = build_model(dict(cfg))
    model = init(device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return model, functools.partial(apply, policy=policy, **FLAGS)


def _sgd(model, mesh):
    """The port's Optimizer, clip off, stepping momentum SGD: optax.sgd(LR,
    momentum=0.9)'s arithmetic."""
    opt = make_optimizer(model.named_parameters(), LR,
                         grad_clip=float("inf"), mesh=mesh)
    opt.adamw = torch.optim.SGD(opt.trainable, lr=LR, momentum=0.9)
    return opt


# ---------------------------------------------------------------------------
# rank functions (run in the spawned processes)
# ---------------------------------------------------------------------------

def _rank_grads(mesh, x, w, b, bn_w, bn_b, target):
    """One conv (the JAX test's loss, mean(y^2)) and one conv + train-mode
    BatchNorm + ReLU (loss mean(relu(bn(y)) * target)): each rank's share
    of the loss on its rows, the gradients summed over the ranks. Also the
    second loss with each rank's own BatchNorm statistics."""
    torch.set_num_threads(1)
    D = mesh.data
    rows = batch_sharding(mesh).local
    xl, tl = torch.from_numpy(rows(x)), torch.from_numpy(rows(target))
    out = {}
    for name, bn_mesh in (("conv", None), ("bn", mesh), ("bn_per_rank", None)):
        wt = torch.from_numpy(w).requires_grad_()
        bt = torch.from_numpy(b).requires_grad_()
        y = conv2d(xl, wt, bt, policy=FP32_POLICY)
        params = [wt, bt]
        if name == "conv":
            loss = (y * y).mean() / D
        else:
            bn = torch.nn.BatchNorm2d(w.shape[0])
            with torch.no_grad():
                bn.weight.copy_(torch.from_numpy(bn_w))
                bn.bias.copy_(torch.from_numpy(bn_b))
            z, (mean, var) = batchnorm(bn, y, True, mesh=bn_mesh)
            loss = (torch.relu(z) * tl).mean() / D
            params += [bn.weight, bn.bias]
            out[name + "_stats"] = to_host((mean, var))
        loss.backward()
        grads = [p.grad for p in params]
        sum_gradients(grads, mesh)
        out[name] = to_host(grads)
    return out


def _train_case(mesh, name, state):
    cfg, hw, b, use_mask, accum, steps = CASES[name]
    x, y = _batch(1, b, hw)
    model, apply = _port_model(cfg, state)
    opt = _sgd(model, mesh)
    step = make_train_step(apply, compute_norm_stats(x, y), use_mask=use_mask,
                           mesh=mesh, accum_steps=accum)
    rows = batch_sharding(mesh).local
    xl, yl = torch.from_numpy(rows(x)), torch.from_numpy(rows(y))
    losses = [float(step(model, opt, xl, yl)[0])]
    first = to_host(model.state_dict())
    losses += [float(step(model, opt, xl, yl)[0]) for _ in range(steps - 1)]
    return {"losses": losses, "first": first,
            "state": to_host(model.state_dict())}


def _rank_train(mesh, names, states):
    torch.set_num_threads(1)
    out = {n: _train_case(mesh, n, s) for n, s in zip(names, states)}
    # a microbatch the data degree does not divide: JAX's ValueError
    model, apply = _port_model(CFG, states[0])
    step = make_train_step(apply, compute_norm_stats(*_batch(1, 8, 32)),
                           mesh=mesh, accum_steps=8)
    x, y = _batch(1, 8, 32)
    try:
        step(model, _sgd(model, mesh), torch.from_numpy(x[mesh.rows(8)]),
             torch.from_numpy(y[mesh.rows(8)]))
        out["accum_error"] = None
    except ValueError as e:
        out["accum_error"] = str(e)
    return out


def _adamw_run(mesh, state, zero1):
    x, y = _batch(2, 8, 32)
    model, apply = _port_model(CFG, state)
    opt = make_optimizer(model.named_parameters(), 1e-3, mesh=mesh,
                         zero1=zero1)
    step = make_train_step(apply, compute_norm_stats(x, y), use_mask=True,
                           mesh=mesh)
    rows = batch_sharding(mesh).local
    losses = [float(step(model, opt, torch.from_numpy(rows(x)),
                         torch.from_numpy(rows(y)))[0])
              for _ in range(3)]
    return model, opt, losses


def _rank_zero1(mesh, state):
    torch.set_num_threads(1)
    _, rep_opt, rep_losses = _adamw_run(mesh, state, False)
    model, opt, losses = _adamw_run(mesh, state, True)
    sd = opt.state_dict()
    # a reload slices the gathered moments back to this rank's
    again = make_optimizer(model.named_parameters(), 1e-3, mesh=mesh,
                           zero1=True)
    again.load_state_dict(sd)
    names = [n for n, _ in model.named_parameters()]
    reloaded = all(
        torch.equal(again.adamw.state[s2][k], opt.adamw.state[s1][k])
        for (_, _, _, s1), (_, _, _, s2) in zip(opt.shards, again.shards)
        for k in ("exp_avg", "exp_avg_sq"))
    return {"losses": losses, "rep_losses": rep_losses,
            "state": to_host(model.state_dict()),
            "opt": to_host(sd["adamw"]["state"]),
            "rep_opt": to_host(rep_opt.state_dict()["adamw"]["state"]),
            "axes": {names[i]: axis for i, _, axis, _ in opt.shards},
            "reloaded": reloaded}


def _rank_eval(mesh, npz, eval_state, state):
    torch.set_num_threads(1)
    model, apply = _port_model({**CFG, "use_skip_lstm": False}, eval_state)
    ds = NPZSequenceDataset(npz)
    idx = np.arange(len(ds))
    rep = evaluate_model(apply, model, ds, indices=idx, batch_size=8,
                         use_mask=False, mesh=mesh)
    errors = []
    try:
        evaluate_model(apply, model, ds, indices=idx, batch_size=5,
                       use_mask=False, mesh=mesh)
    except ValueError as e:
        errors.append(str(e))
    model, apply = _port_model(CFG, state)
    x = torch.from_numpy(_batch(3, 8, 32, t=3)[0])
    _, _, _, init_state = build_model(dict(CFG))
    y_seq, st = rollout_scan(apply, model, x, init_state, mesh=mesh)
    try:
        rollout_scan(apply, model, x[:5], init_state, mesh=mesh)
    except ValueError as e:
        errors.append(str(e))
    return {"report": rep.to_dict(), "y": to_host(y_seq),
            "state": to_host(st), "errors": errors}


def _fit_cfg(npz, ckpt, **over):
    cfg = TrainConfig().apply_overrides({
        "batch_size": "4", "epochs": "1", "model.base_ch": "4",
        "save_last_every": "1", "checkpoint_dir": ckpt,
        **{k: str(v) for k, v in over.items()}})
    cfg.npz_path = npz
    return cfg


def _fit32(cfg, **kw):
    """``fit`` under the FP32 policy: the loop's ``build_model`` wrapped to
    bind it (here, not in the package)."""
    build = tloop.build_model

    def build32(model_cfg):
        a, init, apply, b = build(model_cfg)
        return a, init, functools.partial(apply, policy=FP32_POLICY), b

    tloop.build_model = build32
    try:
        return tloop.fit(cfg, verbose=False, device="cpu", **kw)
    finally:
        tloop.build_model = build


def _rank_fit(mesh, npz, dirs):
    torch.set_num_threads(1)
    out = {}
    for zero1, ckpt in zip((False, True), dirs):
        res = _fit32(_fit_cfg(npz, ckpt, mesh_data=2, zero1=zero1),
                     group=mesh.group)
        out[zero1] = res["history"]
    return out


def _rank_dies(mesh):
    if mesh.rank == 1:
        os._exit(3)
    mesh.all_reduce(torch.ones(1))     # blocks: its peer is gone
    return "unreachable"


# ---------------------------------------------------------------------------
# the JAX side
# ---------------------------------------------------------------------------

def _jax_variables(cfg, state):
    from unet_convlstm_tpu.utils.torch_weights import (
        convert_pretrained_temporal_unet_checkpoint,
        convert_temporal_unet_checkpoint)
    sd = {k: torch.from_numpy(v) for k, v in state.items()}
    if cfg["type"] == "resnet18":
        return convert_pretrained_temporal_unet_checkpoint(sd)
    return convert_temporal_unet_checkpoint(sd)


def _jax_apply(cfg):
    from unet_convlstm_tpu.core.dtypes import FP32_POLICY as JFP32
    from unet_convlstm_tpu.models import registry as jreg
    _, _, apply, init_state = jreg.build_model(dict(cfg))
    return functools.partial(apply, policy=JFP32), init_state


def _jax_train(name, state, D):
    import jax
    import optax
    from unet_convlstm_tpu.parallel.mesh import make_mesh as j_make_mesh
    from unet_convlstm_tpu.train import steps as jsteps
    from unet_convlstm_tpu.ops import normalize as jnorm
    from unet_convlstm_tpu_torch.utils.torch_weights import (
        state_dict_from_jax)

    cfg, hw, b, use_mask, accum, steps = CASES[name]
    x, y = _batch(1, b, hw)
    v = _jax_variables(cfg, state)
    tx = optax.sgd(LR, momentum=0.9)
    jstate = {"params": v["params"], "stats": v["stats"],
              "opt_state": tx.init(v["params"])}
    step = jsteps.make_train_step(
        _jax_apply(cfg)[0], tx, jnorm.compute_norm_stats(x, y),
        use_mask=use_mask, mesh=j_make_mesh(data=D), donate=False,
        accum_steps=accum)
    losses, states = [], []
    for _ in range(steps):
        jstate, loss, _ = step(jstate, x, y)
        losses.append(float(loss))
        ref = state_dict_from_jax(jax.device_get(
            {"params": jstate["params"], "stats": jstate["stats"]}))
        states.append({k: t.numpy() for k, t in ref.items()})
    return losses, states[0], states[-1]


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

def test_mesh_construction():
    one = make_mesh()
    assert one.shape == {"data": 1, "model": 1} and not one.distributed
    assert make_mesh(data=1).data == 1
    with pytest.raises(ValueError, match="process group"):
        make_mesh(data=2)
    with pytest.raises(NotImplementedError, match="7b"):
        make_mesh(model=2)
    m = Mesh(None, 4, 2, "")
    a = np.arange(8)
    np.testing.assert_array_equal(batch_sharding(m).local(a), [4, 5])
    np.testing.assert_array_equal(replicated_sharding(m).local(a), a)
    assert shard_batch_spec(3) == ("data", None, None)
    with pytest.raises(ValueError, match="not divisible"):
        batch_sharding(m).local(np.arange(6))


def test_run_local_ranks_fails_fast_when_a_rank_dies():
    with pytest.raises(RuntimeError, match="exited with code 3"):
        run_local_ranks(_rank_dies, 2, timeout_s=120)


@pytest.mark.parametrize("D", [2, 4])
def test_dp_gradients_are_synchronized(D):
    """tests/test_parallel.py:100 for the port: D ranks' summed gradients
    equal JAX's single-device gradient, for a conv and for a conv with
    train-mode BatchNorm, whose statistics (and their backward) span the
    ranks; with each rank's own statistics the gradient is another one."""
    import jax
    import jax.numpy as jnp
    from unet_convlstm_tpu.core.dtypes import FP32_POLICY as JFP32
    from unet_convlstm_tpu.ops.conv import batchnorm as jbn
    from unet_convlstm_tpu.ops.conv import conv2d as jconv

    rng = np.random.default_rng(D)
    x = rng.standard_normal((8, 8, 8, 2)).astype(np.float32)
    w = (rng.standard_normal((4, 2, 3, 3)) * 0.3).astype(np.float32)
    b = (rng.standard_normal(4) * 0.1).astype(np.float32)
    bn_w = (rng.random(4) + 0.5).astype(np.float32)
    bn_b = (rng.standard_normal(4) * 0.2).astype(np.float32)
    target = rng.standard_normal((8, 8, 8, 4)).astype(np.float32)
    ranks = run_local_ranks(_rank_grads, D, (x, w, b, bn_w, bn_b, target))

    p = {"w": jnp.asarray(w.transpose(2, 3, 1, 0)), "b": jnp.asarray(b)}
    bn_p = {"scale": jnp.asarray(bn_w), "bias": jnp.asarray(bn_b)}
    bn_s = {"mean": jnp.zeros(4), "var": jnp.ones(4)}

    def conv_loss(p):
        return jnp.mean(jconv(p, jnp.asarray(x), policy=JFP32) ** 2)

    def bn_loss(p, bn_p):
        z, _ = jbn(bn_p, bn_s, jconv(p, jnp.asarray(x), policy=JFP32), True)
        return jnp.mean(jax.nn.relu(z) * target)

    g = jax.grad(conv_loss)(p)
    want_conv = [np.asarray(g["w"]).transpose(3, 2, 0, 1), np.asarray(g["b"])]
    g, gb = jax.grad(bn_loss, argnums=(0, 1))(p, bn_p)
    want_bn = [np.asarray(g["w"]).transpose(3, 2, 0, 1), np.asarray(g["b"]),
               np.asarray(gb["scale"]), np.asarray(gb["bias"])]
    _, new_stats = jbn(bn_p, bn_s, jconv(p, jnp.asarray(x), policy=JFP32),
                       True)
    for r in ranks:        # every rank holds the same, global, gradients
        for got, want in zip(r["conv"], want_conv):
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
        for got, want in zip(r["bn"], want_bn):
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(r["bn_stats"][0],
                                   np.asarray(new_stats["mean"]), rtol=1e-5,
                                   atol=1e-7)
        np.testing.assert_allclose(r["bn_stats"][1],
                                   np.asarray(new_stats["var"]), rtol=1e-5)
        # each rank's own statistics compute another function: the test
        # above would fail with them
        off = max(float(np.abs(a - w_).max() / np.abs(w_).max())
                  for a, w_ in zip(r["bn_per_rank"], want_bn))
        assert off > 1e-3, off


@pytest.mark.parametrize("D", sorted(RUNS))
def test_dp_train_step_matches_jax(D):
    """Three steps of the port's data-parallel step at D ranks against
    one process of the port on the global batch, and against JAX's
    ``make_train_step(mesh=make_mesh(data=D))``, from the same weights:
    the custom model plain, masked and accumulated (K=2), and the ResNet18
    family with its encoder's BatchNorm in train mode."""
    names = RUNS[D]
    states = [_init_state(CASES[n][0]) for n in names]
    ranks = run_local_ranks(_rank_train, D, (names, states), timeout_s=240)
    for r in ranks[1:]:        # the ranks agree bit for bit
        for n in names:
            assert r[n]["losses"] == ranks[0][n]["losses"]
            for k, v in ranks[0][n]["state"].items():
                np.testing.assert_array_equal(r[n]["state"][k], v)
    assert "not divisible by the mesh data degree" in ranks[0]["accum_error"]
    for n, state in zip(names, states):
        got = ranks[0][n]
        one = _train_case(make_mesh(), n, state)
        np.testing.assert_allclose(got["losses"], one["losses"], rtol=2e-5,
                                   err_msg=f"{n}: one process")
        for k, want in one["state"].items():
            np.testing.assert_allclose(got["state"][k], want, rtol=1e-4,
                                       atol=1e-5, err_msg=f"{n}: {k}")
        losses, first, last = _jax_train(n, state, D)
        np.testing.assert_allclose(got["losses"], losses, rtol=2e-5,
                                   err_msg=f"{n}: JAX")
        for k, want in last.items():
            if k.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(got["state"][k], want, rtol=1e-4,
                                           atol=1e-5, err_msg=f"{n}: {k}")
        keys = [k for k in last if not k.endswith(
            ("running_mean", "running_var", "num_batches_tracked"))]
        for ref, ours, worst, l2 in ((first, got["first"], 1e-4, None),
                                     (last, got["state"], None, 2e-2)):
            diff = np.concatenate([(ours[k] - ref[k]).ravel() for k in keys])
            moved = np.linalg.norm(np.concatenate(
                [(ref[k] - state[k]).ravel() for k in keys]))
            if worst:
                assert np.abs(diff).max() <= worst * moved, n
            if l2:
                assert np.linalg.norm(diff) <= l2 * moved, n


def _spec_axis(t: torch.Tensor):
    """The axis a marker tensor varies along (None if constant)."""
    for a in range(t.dim()):
        if t.shape[a] > 1 and not torch.equal(t, t.narrow(a, 0, 1)
                                              .expand_as(t)):
            return a
    return None


@pytest.mark.parametrize("D", [2, 4])
@pytest.mark.parametrize("cfg", [CFG, RESNET_CFG], ids=["custom", "resnet"])
def test_zero1_partition_follows_jax_rule(cfg, D):
    """Each trainable leaf's ZeRO-1 axis is the one the JAX rule
    (MeshRules.opt_state_spec) gives its JAX counterpart, ties included."""
    import jax
    from unet_convlstm_tpu.parallel.mesh import MeshRules as JRules
    from unet_convlstm_tpu.parallel.mesh import make_mesh as j_make_mesh
    from unet_convlstm_tpu_torch.utils.torch_weights import (
        state_dict_from_jax)

    state = _init_state(cfg)
    v = _jax_variables(cfg, state)
    jrules = JRules(j_make_mesh(data=D), shard_opt_state_data=True)

    def marker(key_path, leaf):
        keys = tuple(getattr(k, "key", "") for k in key_path)
        spec = tuple(jrules.opt_state_spec(keys, leaf))
        m = np.zeros(leaf.shape, np.float32)
        if "data" in spec:
            a = spec.index("data")
            shape = [1] * leaf.ndim
            shape[a] = leaf.shape[a]
            m = m + np.arange(1, leaf.shape[a] + 1).reshape(shape)
        return m

    marked = jax.tree_util.tree_map_with_path(marker, v["params"])
    want = state_dict_from_jax({"params": marked, "stats": v["stats"]})
    rules = MeshRules(Mesh(None, D, 0, ""), shard_opt_state_data=True)
    _, init, _, _ = build_model(dict(cfg))
    model = init(device="cpu")
    n_sharded = 0
    for name, p in model.named_parameters():
        axis = rules.zero1_axis(name, p)
        assert axis == _spec_axis(want[name]), name
        n_sharded += axis is not None
    assert n_sharded >= len(list(model.parameters())) // 2


def test_zero1_matches_replicated_and_checkpoints():
    """ZeRO-1 at D=2 against replicated data parallelism, both with AdamW:
    losses, parameters and the gathered moments bit-equal; the moments
    split along MeshRules' axes; a reload slices them back."""
    state = _init_state(CFG)
    ranks = run_local_ranks(_rank_zero1, 2, (state,))
    r0 = ranks[0]
    assert r0["losses"] == r0["rep_losses"]
    for i, st in r0["rep_opt"].items():
        for k in ("exp_avg", "exp_avg_sq"):
            np.testing.assert_array_equal(r0["opt"][i][k], st[k])
    for r in ranks:
        assert r["reloaded"]
        for k, v in r0["state"].items():
            np.testing.assert_array_equal(r["state"][k], v)
    rules = MeshRules(Mesh(None, 2, 0, ""), shard_opt_state_data=True)
    _, init, _, _ = build_model(dict(CFG))
    named = dict(init(device="cpu").named_parameters())
    assert r0["axes"] == {n: a for n, p in named.items()
                          if (a := rules.zero1_axis(n, p)) is not None}


@pytest.fixture(scope="module")
def mnist_npz(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("dp") / "mm.npz")
    save_moving_mnist_npz(path, seq_len=2, num_samples=16, image_size=32,
                          num_digits=1, seed=5, as_xy=True)
    return path


def test_evaluate_model_and_rollout_scan_match_single_device(mnist_npz):
    """tests/test_parallel.py:421-500 for the port: ``evaluate_model`` and
    ``rollout_scan`` at D=2 against one process (the JAX test's
    tolerances) and against the JAX package's single-device results; a
    batch the data degree does not divide raises."""
    import jax.numpy as jnp
    from unet_convlstm_tpu.data.npz_dataset import NPZSequenceDataset as JDS
    from unet_convlstm_tpu.eval.metrics import evaluate_model as j_evaluate
    from unet_convlstm_tpu.eval.rollout import rollout_scan as j_rollout

    state = _init_state(CFG)
    eval_cfg = {**CFG, "use_skip_lstm": False}
    eval_state = _init_state(eval_cfg)
    ranks = run_local_ranks(_rank_eval, 2, (mnist_npz, eval_state, state),
                            timeout_s=240)
    one = _rank_eval(make_mesh(), mnist_npz, eval_state, state)
    ds = NPZSequenceDataset(mnist_npz)
    idx = np.arange(len(ds))
    for r in ranks:
        assert len(r["errors"]) == 2
        assert all("not divisible" in e for e in r["errors"])
        m, s = r["report"], one["report"]
        assert m["n_pixels"] == s["n_pixels"]
        for k in ("mae", "rmse", "mae_over_time"):
            np.testing.assert_allclose(m[k], s[k], rtol=1e-5)
        np.testing.assert_allclose(m["bias"], s["bias"], rtol=1e-5,
                                   atol=1e-6)
        for k in ("gt_hist", "pred_hist", "err_hist"):
            np.testing.assert_allclose(m[k], s[k])
        np.testing.assert_allclose(np.sort(m["scatter_gt"]),
                                   np.sort(s["scatter_gt"]), rtol=1e-6)
        np.testing.assert_allclose(r["y"], one["y"], rtol=1e-5, atol=1e-5)
        for a, b in zip(_leaves(r["state"]), _leaves(one["state"])):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)

    japply, _ = _jax_apply(eval_cfg)
    jrep = j_evaluate(japply, _jax_variables(eval_cfg, eval_state),
                      JDS(mnist_npz), indices=idx, batch_size=8,
                      use_mask=False)
    m = ranks[0]["report"]
    for k in ("mae", "rmse"):
        np.testing.assert_allclose(m[k], getattr(jrep, k), rtol=1e-3)
    np.testing.assert_array_equal(m["gt_hist"], jrep.gt_hist)
    assert np.abs(np.asarray(m["pred_hist"]) - jrep.pred_hist).sum() \
        <= 1e-3 * m["n_pixels"]
    japply, jinit = _jax_apply(CFG)
    x = _batch(3, 8, 32, t=3)[0]
    y_j, _ = j_rollout(japply, _jax_variables(CFG, state), jnp.asarray(x),
                       jinit)
    y_j = np.asarray(y_j, np.float32)
    assert np.linalg.norm(ranks[0]["y"] - y_j) <= 1e-3 * np.linalg.norm(y_j)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def test_fit_data_parallel_matches_one_process(mnist_npz, tmp_path):
    """``fit`` at mesh_data=2, with and without ZeRO-1, against ``fit`` in
    one process: the same history, one writer, the same checkpoint."""
    one = _fit32(_fit_cfg(mnist_npz, str(tmp_path / "one")))["history"]
    dirs = [str(tmp_path / "dp"), str(tmp_path / "z1")]
    ranks = run_local_ranks(_rank_fit, 2, (mnist_npz, dirs), timeout_s=240)
    keys = ("train_loss", "val_loss", "train_mae", "val_mae", "val_rmse")
    for r in ranks:
        for zero1 in (False, True):
            (row,), (want,) = r[zero1], one
            for k in keys:
                np.testing.assert_allclose(row[k], want[k], rtol=1e-3,
                                           err_msg=k)
    for d in dirs:             # one writer: one row, not two
        with open(os.path.join(d, "history.csv")) as f:
            assert len(f.read().strip().splitlines()) == 2
    ref, _ = tckpt.restore_checkpoint(str(tmp_path / "one" /
                                          "custom_last.pt"))
    dp, dp_meta = tckpt.restore_checkpoint(os.path.join(dirs[0],
                                                        "custom_last.pt"))
    z1, z1_meta = tckpt.restore_checkpoint(os.path.join(dirs[1],
                                                        "custom_last.pt"))
    keys = [k for k in ref if ref[k].is_floating_point()]
    diff = torch.cat([(dp[k] - ref[k]).flatten() for k in keys])
    assert diff.norm() <= 1e-3 * torch.cat([ref[k].flatten()
                                            for k in keys]).norm()
    for k, v in dp.items():
        assert torch.equal(z1[k], v), k
    for i, st in dp_meta["optimizer"]["adamw"]["state"].items():
        for k, t in st.items():
            assert torch.equal(z1_meta["optimizer"]["adamw"]["state"][i][k],
                               t), (i, k)


def test_fit_checks_the_world_size(mnist_npz, tmp_path, monkeypatch):
    """A launch whose WORLD_SIZE differs from mesh_data raises; so does
    mesh_data > 1 with no process group, and a tensor-parallel mesh."""
    cfg = _fit_cfg(mnist_npz, str(tmp_path), mesh_data=2)
    with pytest.raises(ValueError, match="torchrun"):
        fit(cfg, verbose=False, device="cpu")
    monkeypatch.setenv("WORLD_SIZE", "3")
    with pytest.raises(ValueError, match="WORLD_SIZE=3"):
        fit(cfg, verbose=False, device="cpu")
    with pytest.raises(NotImplementedError, match="7b"):
        fit(_fit_cfg(mnist_npz, str(tmp_path), mesh_model=2), verbose=False,
            device="cpu")
