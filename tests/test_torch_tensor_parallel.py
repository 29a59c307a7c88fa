"""Tensor parallelism of the port (``parallel/tensor.py``; ``MeshRules``'
channel rule and its ZeRO-1 composition; the tensor-parallel train and eval
steps, ``evaluate_model`` and ``rollout_scan`` on a ``(data, model)`` mesh;
``fit`` with ``mesh_model``) against the JAX package on its 8-device
virtual CPU mesh (``tests/test_parallel.py`` holds the JAX side's own
checks), and against the port in one process.

The port's ranks are CPU processes spawned over gloo by ``run_local_ranks``
(``tests/_torch_ranks.py``) as a ``(data, 2)`` mesh; each group has a 60 s
collective timeout and each run a wall-clock limit, so a rank that dies
fails the test instead of hanging the suite. Everything runs in f32 (the
FP32 policies) at base_ch 4, T=2, 16x16 or 32x32. The JAX package reaches
no Pallas kernel here (its flags off); the port's kernel flags are on, so
its fused DoubleConv (K2's plain version on the CPU) runs on each rank's
block of output channels and feeds BatchNorm through the gathered sums.

Tolerances, with their reasons:
* the partition rules: equal to the JAX rules leaf by leaf;
* a channel-sharded conv against ``jax.grad``: forward and gradients
  rtol 1e-5 (the JAX test's), atol 1e-6;
* the whole forward (eval mode) against the JAX ``apply_fn``: 1e-3 of
  max|y| (test_torch_parallel.py's rollout bound: the port's convs add in
  another order than XLA's); against one process of the port: rtol 1e-5,
  atol 1e-6 (each output channel's sums are the same; only the layout of
  the blocks differs);
* training steps, each from the same state (the JAX step's trajectory,
  carried into both the ranks and one process of the port): the loss
  rtol 1e-5 and the metric sums rtol 1e-4; the parameters after the step
  in units of the learning rate, as phase 5 of chip_smoke.py measures
  them (``TRAIN_F32_TOL``): AdamW's first updates move each element by
  about +-lr whatever |g| is (it divides by sqrt(nu), see
  tests/test_parallel.py:145-151), so an element whose gradient lies below
  the two computations' f32 difference may take the other sign: at most
  0.5% of the elements may have moved differently by more than lr/2, and
  the rest within an RMS of 5e-2 lr; the BatchNorm running statistics
  rtol 1e-4, atol 1e-5 (test_torch_parallel.py's);
* the replicated leaves on every rank, and ZeRO-1 on top against
  replicated moments: bit-equal;
* ``evaluate_model``, ``make_eval_step`` and ``rollout_scan`` against one
  process: test_torch_parallel.py's (rtol 1e-5, histograms equal);
* ``fit`` at (2, 2) with ZeRO-1: a finite history, and the checkpoint
  the ranks' gathered state, bit for bit.

The rank functions below import no JAX: a spawned rank imports this module
to find them.
"""

import copy
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
from unet_convlstm_tpu_torch.ops.conv import Conv2d, conv2d
from unet_convlstm_tpu_torch.ops.normalize import compute_norm_stats
from unet_convlstm_tpu_torch.parallel import (MeshRules, TreeSharding,
                                              full_state_dict,
                                              load_full_state_dict,
                                              make_mesh, shard_model)
from unet_convlstm_tpu_torch.parallel.mesh import Mesh, sum_gradients
from unet_convlstm_tpu_torch.parallel.tensor import model_axis
from unet_convlstm_tpu_torch.train import checkpoint as tckpt
from unet_convlstm_tpu_torch.train import loop as tloop
from unet_convlstm_tpu_torch.train.config import TrainConfig
from unet_convlstm_tpu_torch.train.optim import make_optimizer
from unet_convlstm_tpu_torch.train.steps import (make_eval_step,
                                                 make_train_step)

from _torch_ranks import run_local_ranks, to_host

MODEL = 2                 # the model degree of every mesh here
CFG = {"type": "custom", "base_ch": 4, "use_skip_lstm": True,
       "lstm_layers": 1}
# unfrozen: the encoder's convs train, sharded, with train-mode BatchNorm
RESNET_CFG = {"type": "resnet18", "lstm_layers": 1, "freeze_encoder": False,
              "pretrained_resolved": True}
FLAGS = dict(use_pallas=True, use_fused_doubleconv=True)
LR = 1e-3
# name: (model config, height and width, global batch, use_mask, steps)
TRAIN_CASES = {"custom": (CFG, 16, 8, True, 3),
               "resnet": (RESNET_CFG, 32, 4, True, 1)}
PARAMS_FLIPPED, PARAMS_RMS_LR = 5e-3, 5e-2   # chip_smoke.TRAIN_F32_TOL's


def _batch(seed, b, hw, t=2):
    rng = np.random.default_rng(seed)
    x = rng.gamma(2.0, 0.7, (b, t, hw, hw, 2)).astype(np.float32)
    y = (rng.standard_normal((b, t, hw, hw, 1)) * 3).astype(np.float32)
    return x, y


def _init_state(cfg, seed=0):
    _, init, _, _ = build_model(dict(cfg))
    model = init(torch.Generator().manual_seed(seed), device="cpu")
    return {k: v.numpy().copy() for k, v in model.state_dict().items()}


def _port_model(cfg, state, mesh=None, zero1=False):
    """The port's model holding ``state``, narrowed to this rank's shards
    when ``mesh`` has a model axis; (model, apply, sharding or None)."""
    _, init, apply, _ = build_model(dict(cfg))
    model = init(device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    sharding = None
    if mesh is not None and mesh.model > 1:
        sharding = MeshRules(mesh, shard_model_channels=True,
                             shard_opt_state_data=zero1
                             ).tree_sharding(model.state_dict())
        shard_model(model, sharding)
    return (model, functools.partial(apply, policy=FP32_POLICY, **FLAGS),
            sharding)


def _load_state(model, opt, st, mesh=None):
    """A one-process train state (model state, AdamW moments by parameter
    name and their count) into a (possibly sharded) model and its
    optimizer."""
    load_full_state_dict(model, {k: torch.from_numpy(v)
                                 for k, v in st["model"].items()}, mesh)
    sd = opt.state_dict()
    names = [n for n, _ in model.named_parameters()]
    sd["adamw"]["state"] = {} if not st["count"] else {
        i: {"step": torch.tensor(float(st["count"])),
            "exp_avg": torch.from_numpy(st["mu"][n]).clone(),
            "exp_avg_sq": torch.from_numpy(st["nu"][n]).clone()}
        for i, n in enumerate(names)}
    opt.load_state_dict(sd)


def _stepper(cfg, use_mask, st, x, y, mesh=None, zero1=False):
    """(model, optimizer, step from a state): ``step(st)`` loads the train
    state ``st`` and takes one step on this rank's rows, returning the
    loss and the metric sums."""
    model, apply, sharding = _port_model(cfg, st["model"], mesh, zero1)
    opt = make_optimizer(model.named_parameters(), LR, mesh=mesh,
                         zero1=zero1)
    step = make_train_step(apply, compute_norm_stats(x, y),
                           use_mask=use_mask, mesh=mesh,
                           state_sharding=sharding)
    rows = mesh.rows(x.shape[0]) if mesh is not None else slice(None)
    xl, yl = torch.from_numpy(x[rows]), torch.from_numpy(y[rows])

    def step_from(st):
        _load_state(model, opt, st, mesh)
        loss, sums = step(model, opt, xl, yl)
        return float(loss), [float(t) for t in sums]

    return model, opt, step_from


# ---------------------------------------------------------------------------
# rank functions (run in the spawned processes)
# ---------------------------------------------------------------------------

def _rank_conv(mesh, x, w, b):
    """The JAX test's conv (8 -> 256) channel-sharded over 'model', loss
    mean(y^2): the output gathered over the data ranks, the gradients of
    the weight (gathered over 'model'), bias and input, the loss being each
    rank's share and the parameter gradients summed over 'data'."""
    torch.set_num_threads(1)
    conv = Conv2d(8, 256, 3)
    conv.load_state_dict({"weight": torch.from_numpy(w),
                          "bias": torch.from_numpy(b)})
    sharding = MeshRules(mesh, shard_model_channels=True).tree_sharding(
        conv.state_dict())
    shard_model(conv, sharding)
    xl = torch.from_numpy(x[mesh.rows(x.shape[0])]).requires_grad_()
    y = conv2d(xl, conv, policy=FP32_POLICY, mesh=mesh)
    ((y * y).mean() / mesh.data).backward()
    grads = [conv.weight.grad, conv.bias.grad]
    sum_gradients(grads, mesh)
    return {"y": to_host(mesh.all_gather(y.detach())),
            "dx": to_host(mesh.all_gather(xl.grad)),
            "dw": to_host(mesh.all_gather(grads[0], axis="model")),
            "db": to_host(grads[1]),
            "local_out": conv.weight.shape[0],
            "axis": model_axis(conv.weight)}


def _rank_forward(mesh, cases):
    """Each family's forward (eval mode) on this rank's rows, gathered."""
    torch.set_num_threads(1)
    out = {}
    for name, (cfg, state, x) in cases.items():
        model, apply, _ = _port_model(cfg, state, mesh)
        with torch.inference_mode():
            y, _, _ = apply(model, torch.from_numpy(x[mesh.rows(len(x))]),
                            train=False, mesh=mesh)
        out[name] = to_host(mesh.all_gather(y))
    return out


def _rank_train(mesh, inputs):
    """Each case's steps, each from the given state: rank 0's losses, sums
    and gathered states; on every rank, the replicated leaves (for
    bit-identity across ranks) and, for the custom model, whether ZeRO-1
    on top gave the same bits."""
    torch.set_num_threads(1)
    out = {}
    for name, (x, y, states) in inputs.items():
        cfg, _, _, use_mask, steps = TRAIN_CASES[name]
        runs = {}
        for zero1 in (False, True) if name == "custom" else (False,):
            model, opt, step_from = _stepper(cfg, use_mask, states[0], x, y,
                                             mesh, zero1)
            runs[zero1] = []
            for k in range(steps):
                loss, sums = step_from(states[k])
                params = dict(model.named_parameters())
                # copies: the next step updates the live tensors in place
                runs[zero1].append(copy.deepcopy((
                    loss, sums, full_state_dict(model, mesh),
                    opt.state_dict()["adamw"]["state"],
                    {n: t for n, t in model.state_dict().items()
                     if model_axis(params.get(n)) is None})))
        rep = runs[False]
        out[name] = {
            "losses": [r[0] for r in rep], "sums": [r[1] for r in rep],
            "states": to_host([r[2] for r in rep]) if mesh.rank == 0
            else None,
            "replicated": to_host([r[4] for r in rep]),
            "zero1_bit_equal": True not in runs or all(
                a[0] == b[0] and all(torch.equal(a[2][n], t)
                                     for n, t in b[2].items())
                and all(torch.equal(a[3][i][key], t)
                        for i, st in b[3].items() for key, t in st.items())
                for a, b in zip(runs[True], runs[False])),
            "sharded": sorted(n for n, p in model.named_parameters()
                              if model_axis(p) is not None)}
    return out


def _fit_cfg(npz, ckpt, **over):
    cfg = TrainConfig().apply_overrides({
        "batch_size": "4", "epochs": "1", "model.base_ch": "4",
        "model.use_skip_lstm": "false", "save_last_every": "1",
        "checkpoint_dir": ckpt, **{k: str(v) for k, v in over.items()}})
    cfg.npz_path = npz
    return cfg


def _fit32(cfg, **kw):
    """``fit`` under the FP32 policy (the loop's ``build_model`` wrapped
    here, not in the package)."""
    build = tloop.build_model

    def build32(model_cfg):
        a, init, apply, b = build(model_cfg)
        return a, init, functools.partial(apply, policy=FP32_POLICY), b

    tloop.build_model = build32
    try:
        return tloop.fit(cfg, verbose=False, device="cpu", **kw)
    finally:
        tloop.build_model = build


def _rank_fit(mesh, npz, ckpt):
    """``fit`` at (2, 2) with ZeRO-1, then a resume for a second epoch on
    the same mesh: the histories, the gathered model and optimizer state
    after the first run, and how the kernels were split."""
    torch.set_num_threads(1)
    over = dict(mesh_data=2, mesh_model=MODEL, zero1=True)
    res = _fit32(_fit_cfg(npz, ckpt, **over), group=mesh.group)
    model, opt = res["model"], res["optimizer"]
    out = {"history": res["history"],
           "state": to_host(full_state_dict(model, res["mesh"])),
           "optimizer": to_host(opt.state_dict()["adamw"]["state"]),
           "shards": sum(model_axis(p) is not None
                         for p in model.parameters())}
    again = _fit32(_fit_cfg(npz, ckpt + "_resumed", epochs=2, **over),
                   group=mesh.group,
                   resume_from=os.path.join(ckpt, "custom_last.pt"))
    out["resumed"] = again["history"]
    return out


def _rank_eval(mesh, npz, eval_state, state):
    """``evaluate_model`` and ``make_eval_step`` with ``variables_sharding``,
    and ``rollout_scan``, on this mesh (or in one process)."""
    torch.set_num_threads(1)
    tp = mesh.model > 1
    model, apply, sharding = _port_model({**CFG, "use_skip_lstm": False},
                                         eval_state, mesh if tp else None)
    ds = NPZSequenceDataset(npz)
    rep = evaluate_model(apply, model, ds, indices=np.arange(len(ds)),
                         batch_size=8, use_mask=False,
                         mesh=mesh if tp else None,
                         variables_sharding=sharding)
    x, y = _batch(4, 8, 32)
    step = make_eval_step(apply, compute_norm_stats(x, y), use_mask=True,
                          variables_sharding=sharding)
    rows = mesh.rows(8) if tp else slice(None)
    loss, sums = step(model, torch.from_numpy(x[rows]),
                      torch.from_numpy(y[rows]), 7)
    model, apply, _ = _port_model(CFG, state, mesh if tp else None)
    _, _, _, init_state = build_model(dict(CFG))
    xr = torch.from_numpy(_batch(3, 8, 32, t=3)[0])
    y_seq, st = rollout_scan(apply, model, xr, init_state,
                             mesh=mesh if tp else None)
    return {"report": rep.to_dict(), "loss": float(loss),
            "sums": [float(t) for t in sums], "y": to_host(y_seq),
            "state": to_host(st)}


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


def _port_state(jstate):
    """A JAX train state (params, stats, clip + adamw state) in the port's
    names: the model state, the moments by parameter name, their count."""
    import jax
    from unet_convlstm_tpu_torch.utils.torch_weights import (
        state_dict_from_jax)

    g = jax.device_get(jstate)

    def tree(params):
        return {k: v.numpy() for k, v in state_dict_from_jax(
            {"params": params, "stats": g["stats"]}).items()}

    adam = g["opt_state"][1].inner_state[0]
    return {"model": tree(g["params"]), "mu": tree(adam.mu),
            "nu": tree(adam.nu), "count": int(adam.count)}


def _jax_tp_train(name):
    """The JAX package's tensor-parallel step on a (2, 2) mesh of the
    virtual devices (``MeshRules(shard_model_channels=True)
    .tree_sharding`` of the whole train state), from the port's init:
    (x, y, the states before and after each step, losses, sums)."""
    import jax
    from unet_convlstm_tpu.ops import normalize as jnorm
    from unet_convlstm_tpu.parallel.mesh import MeshRules as JRules
    from unet_convlstm_tpu.parallel.mesh import batch_sharding as j_batch
    from unet_convlstm_tpu.parallel.mesh import make_mesh as j_make_mesh
    from unet_convlstm_tpu.train import optim as joptim
    from unet_convlstm_tpu.train import steps as jsteps

    cfg, hw, b, use_mask, steps = TRAIN_CASES[name]
    x, y = _batch(1, b, hw)
    v = _jax_variables(cfg, _init_state(cfg))
    tx = joptim.make_optimizer(LR)
    jstate = {"params": v["params"], "stats": v["stats"],
              "opt_state": tx.init(v["params"])}
    mesh = j_make_mesh(data=2, model=MODEL)
    shard = JRules(mesh, shard_model_channels=True).tree_sharding(jstate)
    jstate = jax.device_put(jstate, shard)
    step = jsteps.make_train_step(
        _jax_apply(cfg)[0], tx, jnorm.compute_norm_stats(x, y),
        use_mask=use_mask, mesh=mesh, state_sharding=shard, donate=False)
    xd, yd = (jax.device_put(a, j_batch(mesh)) for a in (x, y))
    states, losses, sums = [_port_state(jstate)], [], []
    for _ in range(steps):
        jstate, loss, s = step(jstate, xd, yd)
        losses.append(float(loss))
        sums.append([float(t) for t in s])
        states.append(_port_state(jstate))
    return x, y, states, losses, sums


def _lr_units(got, want, names):
    """Parameters after a step, in units of lr: the share of elements that
    moved differently by more than lr/2, and the RMS of the rest."""
    d = np.concatenate([((got[n] - want[n]) / LR).ravel() for n in names])
    big = np.abs(d) > 0.5
    return float(big.mean()), float(np.sqrt((d[~big] ** 2).mean()))


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

RULE_CFGS = {"custom": {**CFG, "base_ch": 8},
             "resnet": {"type": "resnet18", "lstm_layers": 2,
                        "in_channels": 2, "freeze_encoder": True,
                        "pretrained_resolved": True}}
# 4-D leaves split over 'model' at model 2, of all 4-D leaves: the custom
# model's 1x1 head (1 channel) and the resnet18 head (3x3, 16 -> 1) stay
# whole (the JAX rule gives the same counts on the JAX package's trees)
RULE_COUNTS = {"custom": (25, 26), "resnet": (40, 41)}


def _spec_axis(t: torch.Tensor):
    """The axis a marker tensor varies along (None if constant)."""
    for a in range(t.dim()):
        if t.shape[a] > 1 and not torch.equal(t, t.narrow(a, 0, 1)
                                              .expand_as(t)):
            return a
    return None


@pytest.mark.parametrize("zero1", [False, True], ids=["tp", "tp_zero1"])
@pytest.mark.parametrize("family", sorted(RULE_CFGS))
def test_partition_rules_match_jax(family, zero1):
    """tests/test_parallel.py:55, :121 and :318 for the port: at (4, 2) each
    leaf's 'model' axis (MeshRules.param_spec) and each moment's 'model'
    and 'data' axes (opt_state_spec, ZeRO-1 composed on top) are the ones
    the JAX rules give its JAX counterpart, mapped by name and by axis;
    tree_sharding carries the same specs."""
    import jax
    from unet_convlstm_tpu.parallel.mesh import MeshRules as JRules
    from unet_convlstm_tpu.parallel.mesh import make_mesh as j_make_mesh
    from unet_convlstm_tpu_torch.utils.torch_weights import (
        state_dict_from_jax)

    cfg = RULE_CFGS[family]
    state = _init_state(cfg)
    v = _jax_variables(cfg, state)
    jrules = JRules(j_make_mesh(data=4, model=MODEL),
                    shard_model_channels=True, shard_opt_state_data=zero1)

    def markers(rule, axis):
        def marker(key_path, leaf):
            keys = tuple(getattr(k, "key", "") for k in key_path)
            spec = tuple(getattr(jrules, rule)(keys, leaf))
            m = np.zeros(leaf.shape, np.float32)
            if axis in spec:
                a = spec.index(axis)
                shape = [1] * leaf.ndim
                shape[a] = leaf.shape[a]
                m = m + np.arange(1, leaf.shape[a] + 1).reshape(shape)
            return m
        marked = jax.tree_util.tree_map_with_path(marker, v["params"])
        return state_dict_from_jax({"params": marked, "stats": v["stats"]})

    want = {(rule, axis): markers(rule, axis)
            for rule in ("param_spec", "opt_state_spec")
            for axis in ("model", "data")}
    rules = MeshRules(Mesh(None, 4, 0, "", model=MODEL),
                      shard_model_channels=True, shard_opt_state_data=zero1)
    _, init, _, _ = build_model(dict(cfg))
    model = init(device="cpu")
    tree = rules.tree_sharding(model.state_dict())
    assert isinstance(tree, TreeSharding)
    n4 = n_model = 0
    for name, p in model.named_parameters():
        path = tuple(name.split("."))
        for rule in ("param_spec", "opt_state_spec"):
            spec = getattr(rules, rule)(path, p)
            assert spec == (tree.params if rule == "param_spec"
                            else tree.moments)[name], name
            for axis in ("model", "data"):
                got = spec.index(axis) if axis in spec else None
                assert got == _spec_axis(want[rule, axis][name]), \
                    (name, rule, axis)
        n4 += p.dim() == 4
        n_model += tree.model_axis(name) is not None
    assert (n_model, n4) == RULE_COUNTS[family]
    for name, t in model.named_buffers():     # BatchNorm statistics: whole
        assert tree.params[name] == ()
    if zero1:    # a kernel's moment carries both axes, on different dims
        assert any({"model", "data"} <= set(s) for s in tree.moments.values())


@pytest.mark.parametrize("data", [1, 2], ids=["1x2", "2x2"])
def test_channel_sharded_conv_matches_jax(data):
    """tests/test_parallel.py:29 for the port: a conv whose output channels
    are split over 'model' computes the replicated conv, and its gradients
    are jax.grad's, at (1, 2) and (2, 2)."""
    import jax
    import jax.numpy as jnp
    from unet_convlstm_tpu.core.dtypes import FP32_POLICY as JFP32
    from unet_convlstm_tpu.ops.conv import conv2d as jconv

    rng = np.random.default_rng(data)
    x = rng.standard_normal((4, 16, 16, 8)).astype(np.float32)
    w = (rng.standard_normal((256, 8, 3, 3)) * 0.1).astype(np.float32)
    b = (rng.standard_normal(256) * 0.1).astype(np.float32)
    ranks = run_local_ranks(_rank_conv, data * MODEL, (x, w, b),
                            model=MODEL, timeout_s=240)
    p = {"w": jnp.asarray(w.transpose(2, 3, 1, 0)), "b": jnp.asarray(b)}

    def loss(p, x):
        return jnp.mean(jconv(p, x, policy=JFP32) ** 2)

    y_j = np.asarray(jconv(p, jnp.asarray(x), policy=JFP32))
    gp, gx = jax.grad(loss, argnums=(0, 1))(p, jnp.asarray(x))
    want = {"y": y_j, "dx": np.asarray(gx),
            "dw": np.asarray(gp["w"]).transpose(3, 2, 0, 1),
            "db": np.asarray(gp["b"])}
    for r in ranks:
        assert r["local_out"] == 256 // MODEL and r["axis"] == 0
        for k, v in want.items():
            np.testing.assert_allclose(r[k], v, rtol=1e-5, atol=1e-6,
                                       err_msg=k)


def test_tp_forward_matches_jax_and_one_process():
    """tests/test_parallel.py:67 for the port: the custom model and the
    resnet18 family, every conv kernel the rule splits sharded over
    'model' at (2, 2), against the JAX apply_fn and one process."""
    cases = {}
    for name, cfg in (("custom", CFG), ("resnet", RESNET_CFG)):
        cases[name] = (cfg, _init_state(cfg), _batch(2, 4, 32)[0])
    ranks = run_local_ranks(_rank_forward, 2 * MODEL, (cases,),
                            model=MODEL, timeout_s=240)
    for name, (cfg, state, x) in cases.items():
        model, apply, _ = _port_model(cfg, state)
        with torch.inference_mode():
            one = apply(model, torch.from_numpy(x), train=False)[0].numpy()
        japply, _ = _jax_apply(cfg)
        y_j = np.asarray(japply(_jax_variables(cfg, state), x,
                                train=False)[0], np.float32)
        for r in ranks:
            np.testing.assert_allclose(r[name], one, rtol=1e-5, atol=1e-6,
                                       err_msg=name)
            assert np.abs(r[name] - y_j).max() <= 1e-3 * np.abs(y_j).max(), \
                name


def test_tp_train_steps_match_jax_and_one_process():
    """tests/test_parallel.py:142 for the port, with AdamW, at (2, 2): the
    custom model's three steps, each from the state of JAX's
    tensor-parallel step on its (2, 2) mesh, against that step and one
    process of the port from the same state; the resnet18 family's first
    step (unfrozen) against one process (its forward is held against JAX
    above; one JAX tensor-parallel compile is kept, since XLA's in-process
    CPU collectives of such a step can stall under the suite's CPU
    contention). The ranks hold the same replicated leaves, and ZeRO-1 on
    top gives the same bits."""
    runs = {"custom": _jax_tp_train("custom")}
    _, hw, b, _, _ = TRAIN_CASES["resnet"]
    x, y = _batch(1, b, hw)
    init = {"model": _init_state(RESNET_CFG), "mu": {}, "nu": {}, "count": 0}
    runs["resnet"] = (x, y, [init], None, None)
    inputs = {n: (x, y, states[:TRAIN_CASES[n][4]])
              for n, (x, y, states, _, _) in runs.items()}
    ranks = run_local_ranks(_rank_train, 2 * MODEL, (inputs,), model=MODEL,
                            timeout_s=300)
    for name, (x, y, states, losses, sums) in runs.items():
        cfg, _, _, use_mask, steps = TRAIN_CASES[name]
        got = ranks[0][name]
        assert got["sharded"], name
        for r in ranks:
            assert r[name]["zero1_bit_equal"], name
            assert r[name]["losses"] == got["losses"], name
            for a, b in zip(r[name]["replicated"], got["replicated"]):
                for k, t in b.items():
                    np.testing.assert_array_equal(a[k], t, err_msg=k)
        for k in range(steps):
            model, _, step_from = _stepper(cfg, use_mask, states[k], x, y)
            lo, so = step_from(states[k])
            one = {n: t.numpy() for n, t in model.state_dict().items()}
            names = [n for n, _ in model.named_parameters()]
            refs = [(one, "one process")]
            want = [(lo, so, "one process")]
            if losses is not None:
                refs.append((states[k + 1]["model"], "JAX"))
                want.append((losses[k], sums[k], "JAX"))
            for ref, tag in refs:
                flipped, rms = _lr_units(got["states"][k], ref, names)
                assert flipped <= PARAMS_FLIPPED and rms <= PARAMS_RMS_LR, \
                    (name, k, tag, flipped, rms)
                for n in ref:
                    if n.endswith(("running_mean", "running_var")):
                        np.testing.assert_allclose(
                            got["states"][k][n], ref[n], rtol=1e-4,
                            atol=1e-5, err_msg=f"{name} {k} {tag} {n}")
            for want_loss, want_sums, tag in want:
                np.testing.assert_allclose(got["losses"][k], want_loss,
                                           rtol=1e-5, err_msg=tag)
                np.testing.assert_allclose(got["sums"][k], want_sums,
                                           rtol=1e-4, err_msg=tag)


@pytest.fixture(scope="module")
def mnist_npz(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tp") / "mm.npz")
    save_moving_mnist_npz(path, seq_len=2, num_samples=16, image_size=32,
                          num_digits=1, seed=5, as_xy=True)
    return path


def test_fit_with_tensor_parallel_mesh(mnist_npz, tmp_path):
    """tests/test_parallel.py:210 for the port: ``fit`` at mesh_data=2,
    mesh_model=2 with ZeRO-1: a finite history; the checkpoint, written by
    global rank 0 alone, is one process's (it loads strict into the
    unsharded model and the one-process optimizer) and holds the ranks'
    gathered state bit for bit; a resume from it runs on the mesh."""
    ckpt = str(tmp_path / "ck")
    ranks = run_local_ranks(_rank_fit, 2 * MODEL, (mnist_npz, ckpt),
                            model=MODEL, timeout_s=300)
    r0 = ranks[0]
    assert r0["shards"] > 0
    for r in ranks:
        (row,) = r["history"]
        assert all(np.isfinite(row[k]) for k in ("train_loss", "val_loss"))
        assert ({k: v for k, v in row.items() if k != "train_time_s"}
                == {k: v for k, v in r0["history"][0].items()
                    if k != "train_time_s"})
        assert [row["epoch"] for row in r["resumed"]] == [2]
        assert np.isfinite(r["resumed"][0]["val_loss"])
    for d in (ckpt, ckpt + "_resumed"):                  # one writer
        with open(os.path.join(d, "history.csv")) as f:
            assert len(f.read().strip().splitlines()) == 2
    # the first run's checkpoint is the ranks' gathered state
    state, meta = tckpt.restore_checkpoint(os.path.join(ckpt,
                                                        "custom_last.pt"))
    cfg = _fit_cfg(mnist_npz, ckpt)
    _, init, _, _ = build_model(dict(cfg.model))
    model = init(device="cpu")
    model.load_state_dict(state, strict=True)
    for k, v in r0["state"].items():
        np.testing.assert_array_equal(state[k].numpy(), v, err_msg=k)
    opt = make_optimizer(model.named_parameters(), 1e-3)
    opt.load_state_dict(meta["optimizer"])
    for i, st in r0["optimizer"].items():
        for k, t in st.items():
            np.testing.assert_array_equal(
                meta["optimizer"]["adamw"]["state"][i][k].numpy(), t)


def test_tp_evaluate_and_eval_step_match_one_process(mnist_npz):
    """``evaluate_model`` and ``make_eval_step`` with ``variables_sharding``
    and ``rollout_scan`` on a (2, 2) mesh, against one process."""
    eval_state = _init_state({**CFG, "use_skip_lstm": False})
    state = _init_state(CFG)
    ranks = run_local_ranks(_rank_eval, 2 * MODEL,
                            (mnist_npz, eval_state, state), model=MODEL,
                            timeout_s=240)
    one = _rank_eval(make_mesh(), mnist_npz, eval_state, state)
    for r in ranks:
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
        np.testing.assert_allclose(r["loss"], one["loss"], rtol=1e-5)
        np.testing.assert_allclose(r["sums"], one["sums"], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(r["y"], one["y"], rtol=1e-5, atol=1e-5)


def test_sharded_model_entry_points_refuse_what_they_cannot_run():
    """A shard needs its mesh; a step's sharding must be tree_sharding's
    and the model must hold its shards; quantize_model takes whole
    models only."""
    from unet_convlstm_tpu_torch.ops.quant import quantize_model

    mesh = Mesh(None, 1, 1, "", model=MODEL)       # model rank 1, no group
    state = _init_state(CFG)
    model, apply, sharding = _port_model(CFG, state, mesh)
    assert model.inc.net[3].weight.shape[0] == 2   # base_ch 4 over 2
    x = torch.from_numpy(_batch(0, 2, 16)[0])
    with pytest.raises(ValueError, match="runs only with its mesh"):
        apply(model, x, train=False)
    with pytest.raises(ValueError, match="needs its mesh"):
        make_optimizer(model.named_parameters(), LR)
    with pytest.raises(ValueError, match="whole model"):
        quantize_model(model)
    whole, apply, _ = _port_model(CFG, state)
    step = make_train_step(apply, compute_norm_stats(*_batch(0, 2, 16)),
                           state_sharding=sharding)
    with pytest.raises(ValueError, match="not sharded as the sharding"):
        step(whole, make_optimizer(whole.named_parameters(), LR), x, x)
    with pytest.raises(TypeError, match="tree_sharding"):
        make_train_step(apply, None, state_sharding={"inc": ()})
    with pytest.raises(ValueError, match="another mesh"):
        make_train_step(apply, None, mesh=Mesh(None, 1, 0, "", model=2),
                        state_sharding=sharding)
    # the shards' blocks: model rank 1 holds the second half
    full = torch.from_numpy(state["inc.net.3.weight"])
    assert torch.equal(model.inc.net[3].weight.detach(), full[2:])
    load_full_state_dict(model, {k: torch.from_numpy(v)
                                 for k, v in state.items()}, mesh)
    assert torch.equal(model.inc.net[3].weight.detach(), full[2:])
